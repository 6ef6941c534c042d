#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phase 5 (the LM serving path) of two source trees
in turns on one GPU.

    python3 tools/ab_phase5.py --parent TREE [--change TREE]

Runs parent, change, change, parent, each in a process of its own that
imports that tree's ``chip_smoke`` and ``repro_torch``, builds the tree's
kernel and calls ``chip_smoke.phase5``: full-width seamless-m4t-medium
``generate`` with its gates, kernel times, prefill and decode times and
their ``torch.profiler`` traces.  ``--change`` defaults to this checkout.
A card set below its maximum power runs slower under load, so two trees
compare only within one session; the turns spread any drift over both.
Exits non-zero if any run fails.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]

RUN = r'''
import sys
import torch
root = sys.argv[1]
sys.path[:0] = [root + "/src", root]
import chip_smoke as cs
from repro_torch.kernels import _build
print("tree", root, cs.__file__, flush=True)
_build.build("dslot_matmul")
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
card = cs.card_line()
cs.log(card)
cs.phase5(card, torch.device("cuda"))
'''


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, help="the tree to compare to")
    ap.add_argument("--change", default=str(HERE))
    args = ap.parse_args()
    failed = 0
    for label in ("parent", "change", "change", "parent"):
        root = str(Path(getattr(args, label)).resolve())
        print(f"===== {label}", flush=True)
        rc = subprocess.run([sys.executable, "-c", RUN, root]).returncode
        print(f"===== {label} rc {rc}", flush=True)
        failed |= rc != 0
    return int(failed)


if __name__ == "__main__":
    sys.exit(main())
