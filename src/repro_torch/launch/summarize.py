"""Render the dry-run table from the sweep's records (port of
``repro.launch.summarize``).  ``fits`` holds a rank's peak against the 80 GB
of an NVIDIA H100 80GB HBM3.

    python -m repro_torch.launch.summarize [--dir build/dryrun]
"""

from __future__ import annotations

import argparse
import glob
import json
import os

CARD_BYTES = 80e9            # H100 80GB HBM3


def row(r: dict) -> dict:
    """One record's table row."""
    c = r.get("corrected", {})
    peak = (r["memory"].get("temp_size_in_bytes", 0)
            + r["memory"].get("argument_size_in_bytes", 0))
    return {
        "arch": r["arch"], "shape": r["shape"],
        "mesh": "2x16x16" if r["multi_pod"] else "16x16",
        "compile_s": r["compile_s"],
        "flops": c.get("dot_flops", 0),
        "hbm": c.get("hbm_bytes", 0),
        "coll": c.get("coll_total_bytes", 0),
        "peak": peak / 1e9,
        "fits": "yes" if peak <= CARD_BYTES else f"NO ({peak / 1e9:.1f})",
    }


def render(rows: list[dict]) -> str:
    lines = ["| arch | shape | mesh | trace s | dot FLOPs/dev | HBM B/dev |"
             " coll B/dev | peak GB | fits 80 GB |",
             "|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
            f"{r['compile_s']:.0f} | {r['flops']:.2e} | {r['hbm']:.2e} | "
            f"{r['coll']:.2e} | {r['peak']:.1f} | {r['fits']} |")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="build/dryrun")
    args = ap.parse_args(argv)
    rows = []
    for f in sorted(glob.glob(os.path.join(args.dir, "*.json"))):
        with open(f) as fh:
            r = json.load(fh)
        if r.get("tag"):
            continue
        rows.append(row(r))
    rows.sort(key=lambda r: (r["arch"], r["shape"], r["mesh"]))
    print(render(rows))


if __name__ == "__main__":
    main()
