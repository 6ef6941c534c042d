"""The knee of an open-loop cell, on the card: its traffic at each of a
list of rates, one short window a rate in one process, printing the
time-to-first-token tail, the completed tokens per second and the requests
in the engine at the window's start and end (a backlog that grows is a rate
past the knee).

    python3 portbench/sweep.py --workload <name> --rates 3,4,5 \
        --seconds 20 --seed 7 --out build/portbench/sweep.jsonl
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench.harness import env  # noqa: E402

env.prepare_paths()


def main(argv=None) -> int:
    import torch

    from portbench.harness import readers, spec

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--out", type=Path, required=True)
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload, env.ROOT / "BENCHMARK.json")
    env.require_cards(int(cell.workload["chips"]))
    dev = torch.device("cuda")
    drv = spec.driver(cell)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    for rate in [float(r) for r in args.rates.split(",")]:
        cell.traffic["rate_per_s"] = rate
        rec = drv.run(cell, args.seed, args.seconds, False, dev,
                      time.perf_counter())
        rec.pop("release")()
        ttft = readers.ttft_ms(rec)
        line = dict(workload=args.workload, rate_per_s=rate,
                    ttft_p50_ms=readers.median(ttft),
                    ttft_p90_ms=readers.percentile(ttft, 90.0),
                    ttft_p95_ms=readers.p95(ttft), first_tokens=len(ttft),
                    itl_p95_ms=readers.p95(readers.itl_ms(rec)),
                    tokens_per_s=readers.window_tokens(rec) / rec["seconds"],
                    live_start_end=rec["live"],
                    admit_step_ms=readers.median(
                        [(s["t1"] - s["t0"]) * 1e3
                         for s in readers.admit_steps(rec)]),
                    card=torch.cuda.get_device_name(0))
        print(json.dumps(line), flush=True)
        with args.out.open("a") as f:
            f.write(json.dumps(line) + "\n")
        del rec
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
