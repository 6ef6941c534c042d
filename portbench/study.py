"""Readings for a cell's correctness limit, on the card: the served-token
gap of the program on many seeds and, on some of them, the control's gap
(the reference in float8 put in the program's place), each at the cell's
own load over a short window.  One process, one line of JSON a seed.

    python3 portbench/study.py --workload <name> --seeds 1,2,3 \
        --control-seeds 1,2 --seconds 15 --out build/portbench/study.jsonl
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


def ints(text: str) -> list[int]:
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    import torch

    from portbench.harness import check, spec

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=ints, required=True)
    ap.add_argument("--control-seeds", type=ints, default=[])
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--rate", type=float, default=None,
                    help="an open loop's rate in place of the mix's")
    ap.add_argument("--out", type=Path, required=True)
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload, env.ROOT / "BENCHMARK.json")
    if args.rate is not None:
        cell.traffic["rate_per_s"] = args.rate
    env.require_cards(int(cell.workload["chips"]))
    dev = torch.device("cuda")
    drv = spec.driver(cell)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    for seed in args.seeds:
        t0 = time.perf_counter()
        rec = drv.run(cell, seed, args.seconds, False, dev, t0)
        rec.pop("release")()
        torch.cuda.empty_cache()
        got = check.gaps(rec["params"], cell.config["model"],
                         cell.config["dslot"], rec["step"], rec["samples"],
                         dev, control=seed in args.control_seeds)
        line = dict(workload=args.workload, seed=seed, **got,
                    step=rec["step"], attempted=rec["attempted"],
                    failed=rec["failed"], setup_s=rec["setup_s"],
                    tokens_per_s=spec.reader(cell, "tokens_per_s").read(rec),
                    seconds=time.perf_counter() - t0,
                    card=torch.cuda.get_device_name(0))
        print(json.dumps(line), flush=True)
        with args.out.open("a") as f:
            f.write(json.dumps(line) + "\n")
        del rec
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
