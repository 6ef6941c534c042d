#!/usr/bin/env python3
"""Time the digit-serial matmul kernel of one source tree on the GPU.

    python3 tools/time_dslot_kernel.py [--root TREE] [--label NAME]
        [--match TEXT]

Builds TREE's ``src/repro_torch/kernels/csrc/dslot_matmul.cu`` (TREE
defaults to this checkout) and times its wrapper ``dslot_matmul_cuda`` at
the timed phase-2 shapes of ``chip_smoke.py`` (f32 weights, 8 planes: the
CNN conv and head at B = 1024, the seamless-m4t-medium MLP up-projection
with ``block_k`` auto and 256, the head at B = 16384, ``block_n = 5`` at the
MLP's K), or with ``--match`` the timed phase-2 cases whose name holds
TEXT (``--match launcher``: the launchers' tiles at the engine's admission
shape), on the same seeded inputs and by the same three measures:
eager (CUDA events over 10 back-to-back calls), a CUDA graph of 20 calls
(device time alone) and the host time to issue one call.  Prints one JSON
line.

To compare two trees, run them in turns on one card in one session
(A, B, B, A): a card set below its maximum power runs slower under load,
so numbers from different sessions do not compare.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE),
                    help="source tree whose kernel is timed")
    ap.add_argument("--label", default=None)
    ap.add_argument("--match", default=None,
                    help="time the timed phase-2 cases whose name holds "
                         "this text instead")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_dslot_kernel: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root / "src"))
    sys.path.insert(1, str(HERE))
    # TREE's package first: chip_smoke puts this checkout's src first
    from repro_torch.kernels import _build
    from repro_torch.kernels import dslot_matmul as dm
    import chip_smoke as cs

    if not Path(dm.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {dm.__file__}, not from {root}")
    _build.build("dslot_matmul")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    result = {"label": args.label or str(root), "card": cs.card_line(),
              "shapes": {}}
    for n, case in enumerate(cs.phase2_cases()):
        if args.match is None and not case.name.endswith("f32 normal n8"):
            continue
        if args.match is not None and not (case.timed
                                           and args.match in case.name):
            continue
        q, prep, kw = cs.run_case(case, seed=100 + n, dev=dev)

        def launch(q=q, w=prep.w, kw=kw):
            return dm.dslot_matmul_cuda(q, w, **kw)

        launch()
        torch.cuda.synchronize()
        result["shapes"][case.name] = {
            "ms": cs.cuda_ms(launch), "graph_ms": cs.graph_ms(launch),
            "host_us": cs.host_us(launch)}
        del q, prep, kw
        torch.cuda.empty_cache()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
