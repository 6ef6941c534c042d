"""The paper's experiment end to end (Figs. 6-9; port of
``examples/mnist_dslot.py``):

train the bias-free 5x5 CNN, run its conv + ReLU + maxpool through the
DSLOT-NN digit-serial simulator for per-class negative-activation rates
(Fig. 8) and cycle savings (Fig. 9), check it bit for bit against the SIP
baseline, print the modeled Table-I figures, then lower the trained weights
once (``prepare_cnn``), fix the activation scales (``calibrate_cnn``) and
sweep the runtime precision from 8 down to 2 digit planes through the
digit-serial kernel without re-preparing.

    python -m repro_torch.launch.mnist_dslot [--per-class 30] [--block-k 64]
        [--n-planes 8] [--smoke] [--json planes.json] [--device cpu]

Everything runs on ``--device`` (default ``cuda``: the CUDA kernel; ``cpu``
runs the kernel's plain version).  Images are synthetic, from fixed seeds.
"""

import argparse
import json


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--per-class", type=int, default=30)
    ap.add_argument("--block-k", type=int, default=None,
                    help="K chunk of the termination check (None = auto)")
    ap.add_argument("--n-planes", type=int, default=None,
                    help="runtime precision knob (digit planes <= n_bits)")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny end-to-end run (fewer samples and epochs)")
    ap.add_argument("--json", type=str, default=None,
                    help="write the per-precision planes-skipped sweep here")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from repro_torch.configs.dslot_mnist import CONFIG
    from repro_torch.core import dslot_conv2d_stats, sip_conv2d, table1_model
    from repro_torch.core.mnist_cnn import (calibrate_cnn, forward,
                                            forward_dslot, prepare_cnn,
                                            train_cnn)
    from repro_torch.data.mnist import synth_mnist
    from repro_torch.device import resolve_device
    from repro_torch.kernels import ops

    dev = resolve_device(args.device)
    if args.smoke:
        args.per_class = min(args.per_class, 12)
    epochs = 3 if args.smoke else 20

    imgs, labels = synth_mnist(args.per_class + 8, seed=0)
    n_eval = 8 * 10
    params, acc = train_cnn(CONFIG, imgs[:-n_eval], labels[:-n_eval],
                            epochs=epochs, lr=2e-2, device=dev)
    print(f"trained bias-free CNN (synthetic MNIST): accuracy {acc:.1%}")

    xe = torch.as_tensor(imgs[-n_eval:]).to(dev)
    ey = torch.as_tensor(labels[-n_eval:]).to(dev)
    if not args.smoke:
        print("\nclass  neg-rate  cycles-saved   (paper Fig. 8 / Fig. 9)")
        rates = []
        for d in range(10):
            res = dslot_conv2d_stats(xe[ey == d], params.conv)
            r = float(res.report.negative_rate)
            s = float(res.report.mean_savings)
            rates.append(r)
            print(f"  {d}     {r:6.1%}     {s:6.1%}")
        print(f"mean negative rate {np.mean(rates):.1%} (paper: ~12.5%)")

    # bit-exactness against the Stripes SIP baseline
    res = dslot_conv2d_stats(xe[:16], params.conv)
    ref = sip_conv2d(xe[:16], params.conv)
    print("\nDSLOT vs SIP max abs diff:",
          float((res.y_conv - ref).abs().max()), "(bit-exact path)")

    m = table1_model()
    print(f"modeled Virtex-7 FPGA perf density (paper eqs. 8-11, not "
          f"measured): DSLOT {m['dslot'].gops_per_watt:.1f} GOPS/W vs SIP "
          f"{m['stripes'].gops_per_watt:.1f} GOPS/W "
          f"(+{m['dslot'].gops_per_watt / m['stripes'].gops_per_watt - 1:.0%})")

    # ---- prepare once / execute many: the weight-stationary serving path
    backend = "cuda" if dev.type == "cuda" else "plain"
    ref_logits = forward(params, xe, CONFIG)
    n0 = ops.prepare_call_count()
    prep = prepare_cnn(params, CONFIG, block_k=args.block_k, block_m=32)
    prep = calibrate_cnn(prep, xe[:16], CONFIG)
    n_prepares = ops.prepare_call_count() - n0
    # weight-side static MSR plane bounds baked in at prepare time: tiles
    # with bound 0 are never issued (bit-exact saving)
    weight_side = {}
    for name, lp in (("conv1", prep.conv_params),
                     ("dense1", prep.head_params)):
        tbl = lp["dslot"].msr_bound
        tbl = None if tbl is None else tbl.tolist()
        weight_side[name] = {
            "bound_table": tbl,
            "bounded_tiles": 0 if tbl is None else sum(
                b < CONFIG.n_bits for b in tbl)}
    print(f"\nprepared {n_prepares} layers once ({backend}, "
          f"block_k={args.block_k}); weight-side bounded tiles: "
          + ", ".join(f"{n} {d['bounded_tiles']}"
                      for n, d in weight_side.items())
          + "; runtime precision sweep:")

    sweep = []
    planes_list = ([args.n_planes] if args.n_planes
                   else list(range(CONFIG.n_bits, 1, -2)))
    for n_planes in planes_list:
        res = forward_dslot(prep, xe, CONFIG, n_planes=n_planes)
        pred = res.logits.argmax(-1)
        agree = float((pred == ref_logits.argmax(-1)).float().mean())
        dslot_acc = float((pred == ey).float().mean())
        row = {"n_planes": n_planes, "argmax_agreement": agree,
               "accuracy": dslot_acc, "layers": {}}
        for name, st in res.layer_stats.items():
            used = st.planes_used.to(torch.float32)
            row["layers"][name] = {
                "planes_used_mean": float(used.mean()),
                "skipped_frac": float(st.skipped_frac),
                # weight-side planes saved: granted budget minus the static
                # MSR bound, per tile (0 unless weights carry inert tiles)
                "planes_bounded_mean": (
                    None if st.planes_bounded is None else
                    float(st.planes_bounded.to(torch.float32).mean())),
            }
            print(f"  D={n_planes}  {name:8s} planes_used "
                  f"{float(used.mean()):5.2f}  skipped "
                  f"{float(st.skipped_frac):6.1%}", end="")
        print(f"   acc {dslot_acc:5.1%}  agree {agree:5.1%}")
        sweep.append(row)
    if ops.prepare_call_count() - n0 != n_prepares:
        raise RuntimeError("precision sweep must not re-prepare weights")

    if args.json:
        with open(args.json, "w") as f:
            json.dump({"smoke": args.smoke, "backend": backend,
                       "train_accuracy": acc, "prepares": n_prepares,
                       "weight_side": weight_side,
                       "precision_sweep": sweep}, f, indent=2)
        print(f"wrote per-precision planes-skipped sweep to {args.json}")


if __name__ == "__main__":
    main()
