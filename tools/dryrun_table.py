#!/usr/bin/env python3
"""One table of the dry-run sweep: each live (arch x shape) cell with its
single-pod (16 x 16) and multi-pod (2 x 16 x 16) records side by side.

    PYTHONPATH=src python3 tools/dryrun_table.py [--dir build/dryrun]

Per mesh: a rank's peak GB against 80 GB (``launch.summarize``), and the
roofline's dominant term, its modeled seconds and the roofline fraction
(``launch.roofline.analyze_cell``: H100 data-sheet rates, 700 W), with the
useful share of the rank's dot FLOPs (MODEL/op).  A cell without a record
shows "-".  Every number is modeled from fake-tensor traces, none
measured.
"""

from __future__ import annotations

import argparse
import json
import os

from repro_torch.configs.registry import live_cells
from repro_torch.launch import roofline, summarize


def cell(path: str) -> str:
    if not os.path.exists(path):
        return "- | - | - | -"
    with open(path) as fh:
        rec = json.load(fh)
    s = summarize.row(rec)
    r = roofline.analyze_cell(rec)
    modeled = max(r["compute_s"], r["memory_s"], r["collective_s"])
    fits = "" if s["fits"] == "yes" else " **NO**"
    return (f"{s['peak']:.1f}{fits} | {r['dominant']} {modeled:.3g} s | "
            f"{r['roofline_frac']:.1%} | {r['useful_ratio']:.3f}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dir", default="build/dryrun")
    args = ap.parse_args(argv)
    print("| arch | shape | 16x16: peak GB | bottleneck | roofline | "
          "MODEL/op | 2x16x16: peak GB | bottleneck | roofline | MODEL/op |")
    print("|---|---|---|---|---|---|---|---|---|---|")
    for arch, shape in sorted(live_cells()):
        row = [cell(os.path.join(args.dir, f"{arch}__{shape}__{m}.json"))
               for m in ("single", "multi")]
        print(f"| {arch} | {shape} | {row[0]} | {row[1]} |")


if __name__ == "__main__":
    main()
