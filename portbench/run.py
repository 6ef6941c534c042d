"""Run one cell of the port's benchmark and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout: the cell's entry in ``BENCHMARK.json`` names
its configuration and traffic files, the traffic names its driver, and
each metric is read by ``metrics/<name>.py``.  With ``--trace 0`` the line
holds the cell's end-to-end metrics, with ``--trace 1`` its per-layer ones
(the window traced by ``torch.profiler``).  After the window the served
tokens of a seeded sample are held against the plain reference; the number
compared and its limit close standard error and the result line.
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


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def measure(args, *, device=None, spec_path=None, bench_dir=None,
            t_start=None) -> dict:
    """One run of a cell: the result object the last line prints.  Tests
    pass ``device`` (the CPU) to skip the look for a card."""
    import torch

    from portbench.harness import check, spec

    cell = spec.load_cell(args.workload,
                          spec_path or env.ROOT / "BENCHMARK.json",
                          bench_dir or spec.BENCH_DIR)
    if device is None:
        env.require_cards(int(cell.workload["chips"]))
        device = torch.device("cuda")
    torch.set_num_threads(2)
    cuda = device.type == "cuda"
    rec = spec.driver(cell).run(cell, args.seed, args.seconds,
                                bool(args.trace), device,
                                T_START if t_start is None else t_start)
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": 1,
           "memory_peak_bytes": int(torch.cuda.max_memory_allocated())
           if cuda else 0}
    if args.trace:
        tr = rec.get("trace") or {}
        dev["busy_s"] = tr.get("busy_s", 0.0)
        dev["window_s"] = tr.get("window_s", 0.0)
    rec.pop("release")()
    if cuda:
        torch.cuda.empty_cache()
    limit = float(cell.config["check"]["logit_gap_limit"])
    got = check.gaps(rec["params"], cell.config["model"],
                     cell.config["dslot"], rec["step"], rec["samples"],
                     device)
    metrics = {}
    for m in cell.metrics(bool(args.trace)):
        v = spec.reader(cell, m["name"]).read(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    ok = bool(rec["samples"]) and got["logit_gap"] <= limit
    out = {"correct": ok, "attempted": rec["attempted"],
           "failed": rec["failed"], "metrics": metrics, "device": dev}
    tr = rec.get("trace")
    if args.trace and tr:
        out["breakdown"] = {"device_ops": tr["device_ops"],
                            "idle_gaps": tr["idle_gaps"]}
    out["check"] = {"logit_gap": {"value": got["logit_gap"], "limit": limit},
                    "tokens_compared": {"value": got["tokens"],
                                        "limit": 1}}
    return out


def main(argv=None) -> int:
    args = parse(argv)
    out = measure(args)
    found = env.forbidden_modules()
    if found:
        print(f"portbench: modules the run must not load: {found}",
              file=sys.stderr)
        return 3
    for name, c in out["check"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
