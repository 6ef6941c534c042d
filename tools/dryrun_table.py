#!/usr/bin/env python3
"""One table of the dry-run sweep: each live (arch x shape) cell with its
single-pod (16 x 16) and multi-pod (2 x 16 x 16) records side by side.

    PYTHONPATH=src python3 tools/dryrun_table.py [--dir build/dryrun]
        [--shape train_4k] [--before <an earlier sweep's dir>]

Per mesh: a rank's peak GB against 80 GB (``launch.summarize``), and the
roofline's dominant term, its modeled seconds and the roofline fraction
(``launch.roofline.analyze_cell``: H100 data-sheet rates, 700 W), with the
useful share of the rank's dot FLOPs (MODEL/op).  A cell without a record
shows "-".  ``--shape`` keeps one shape's rows; ``--before`` puts an
earlier sweep's peak and MODEL/op beside each cell's ("was").  Every
number is modeled from fake-tensor traces, none measured.
"""

from __future__ import annotations

import argparse
import json
import os

from repro_torch.configs.registry import live_cells
from repro_torch.launch import roofline, summarize


def _read(path: str):
    if not os.path.exists(path):
        return None
    with open(path) as fh:
        rec = json.load(fh)
    return summarize.row(rec), roofline.analyze_cell(rec)


def cell(path: str, before: str | None = None) -> str:
    got = _read(path)
    if got is None:
        return "- | - | - | -"
    s, r = got
    modeled = max(r["compute_s"], r["memory_s"], r["collective_s"])
    fits = "" if s["fits"] == "yes" else " **NO**"
    was = _read(before) if before else None
    peak_was = f" (was {was[0]['peak']:.1f})" if was else ""
    op_was = f" (was {was[1]['useful_ratio']:.3f})" if was else ""
    return (f"{s['peak']:.1f}{fits}{peak_was} | {r['dominant']} "
            f"{modeled:.3g} s | {r['roofline_frac']:.1%} | "
            f"{r['useful_ratio']:.3f}{op_was}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dir", default="build/dryrun")
    ap.add_argument("--shape", default=None)
    ap.add_argument("--before", default=None)
    args = ap.parse_args(argv)
    print("| arch | shape | 16x16: peak GB | bottleneck | roofline | "
          "MODEL/op | 2x16x16: peak GB | bottleneck | roofline | MODEL/op |")
    print("|---|---|---|---|---|---|---|---|---|---|")
    for arch, shape in sorted(live_cells()):
        if args.shape and shape != args.shape:
            continue
        name = [f"{arch}__{shape}__{m}.json" for m in ("single", "multi")]
        row = [cell(os.path.join(args.dir, n), args.before and
                    os.path.join(args.before, n)) for n in name]
        print(f"| {arch} | {shape} | {row[0]} | {row[1]} |")


if __name__ == "__main__":
    main()
