#!/usr/bin/env python3
"""Count how many conv tiles of the trained MNIST CNN terminate early, per
tile geometry, beside the digit-serial simulator's per-SOP statistics.

    PYTHONPATH=src python3 tools/cnn_tile_termination.py [--device cpu]

Trains the CNN as ``repro_torch.launch.mnist_dslot`` does at its full
setting (300 synthetic images, 20 epochs, seeded weights), then on the 80
held-out images: the simulator's negative rate and cycles saved per SOP
(Algorithm 1 at one window and one map, the paper's PE), and for each
``(block_m, block_n)`` the conv layer's tiles, how many stopped before 8
planes, ``planes_used_mean`` and ``skipped_frac`` at 8 planes.  A tile
stops only when every one of its ``block_m`` windows x ``block_n`` maps is
provably negative.  The counts are the same on either device (the kernel
and its plain version agree on ``planes_used``); prints one JSON line.
"""

from __future__ import annotations

import argparse
import json

GEOMETRIES = ((32, 8), (32, 1), (8, 1), (4, 1), (1, 1))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.configs.dslot_mnist import CONFIG
    from repro_torch.core import dslot_conv2d_stats
    from repro_torch.core import mnist_cnn as cnn
    from repro_torch.data.mnist import synth_mnist
    from repro_torch.device import resolve_device

    dev = resolve_device(args.device)
    imgs, labels = synth_mnist(38, seed=0)
    params, acc = cnn.train_cnn(CONFIG, imgs[:-80], labels[:-80], device=dev)
    held = torch.as_tensor(imgs[-80:]).to(dev)
    rep = dslot_conv2d_stats(held, params.conv).report
    out = {"device": str(dev), "train_accuracy": acc,
           "simulator": {"sops": rep.is_negative.numel(),
                         "negative_rate": float(rep.negative_rate),
                         "cycles_saved": float(rep.mean_savings)},
           "tiles": []}
    for bm, bn in GEOMETRIES:
        prep = cnn.calibrate_cnn(cnn.prepare_cnn(params, CONFIG, block_m=bm,
                                                 block_n=bn), held[:16],
                                 CONFIG)
        st = cnn.forward_dslot(prep, held, CONFIG,
                               n_planes=8).layer_stats["conv1"]
        used = st.planes_used
        out["tiles"].append({
            "block_m": bm, "block_n": bn, "tiles": used.numel(),
            "terminated": int((used < 8).sum()),
            "planes_used_mean": float(used.float().mean()),
            "skipped_frac": float(st.skipped_frac)})
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
