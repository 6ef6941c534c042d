"""Serving entry point: batched generation with optional DSLOT digit-serial
execution (port of ``repro.launch.serve``).

    python -m repro_torch.launch.serve --arch seamless-m4t-medium --reduced \\
        --batch 4 --max-new 16 [--dslot --n-planes 6] [--device cpu]

``--dslot`` turns on digit-plane execution (with early negative termination)
for every ReLU MLP, prepared once before generation; ``--n-planes`` is the
runtime precision.  The model runs on ``--device`` (default ``cuda``: the
CUDA kernel; ``cpu`` runs the kernel's plain version).  Weights and inputs
are random, from fixed seeds.
"""

import argparse
import dataclasses
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--dslot", action="store_true")
    ap.add_argument("--n-planes", "--planes", type=int, default=8,
                    dest="n_planes")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.configs.base import DslotConfig
    from repro_torch.configs.registry import get_arch
    from repro_torch.device import resolve_device
    from repro_torch.models import stats
    from repro_torch.models.model_zoo import build_model
    from repro_torch.serve.engine import generate

    dev = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.dslot:
        cfg = dataclasses.replace(cfg, dslot=DslotConfig(
            enabled=True, n_planes=args.n_planes, block_m=32, block_n=32))
        if cfg.act != "relu" or cfg.glu:
            print(f"note: {cfg.name} has {cfg.act}/glu MLPs — DSLOT early "
                  "termination applies only to ReLU MLPs; running the "
                  "standard path for those layers.")

    model = build_model(cfg)
    params = model.prepare_dslot(model.init(
        torch.Generator(dev).manual_seed(0), device=dev))
    gen = torch.Generator(dev).manual_seed(1)
    B = args.batch
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, args.prompt_len),
                                     generator=gen, device=dev)}
    if cfg.frontend:
        batch["frontend"] = torch.randn(
            (B, cfg.frontend_len, cfg.d_model), generator=gen,
            device=dev) * 0.02
    if cfg.family == "encdec":
        batch["src_embeds"] = torch.randn(
            (B, 8, cfg.d_model), generator=gen, device=dev) * 0.02

    t0 = time.perf_counter()
    toks = generate(model, params, batch, args.max_new).tokens
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    with stats.collect() as sink:
        if args.dslot:
            model.forward(params, batch)   # eager pass for observable stats
    print(f"arch={cfg.name} device={dev} generated {tuple(toks.shape)} in "
          f"{dt:.2f}s ({B * args.max_new / dt:.1f} tok/s)")
    print("sample:", toks[0, :12].tolist(), "...")
    if sink.get("mlp_dslot_skipped_frac"):
        # one value per MLP call; a stack's groups record theirs stacked
        vals = torch.cat([v.reshape(-1).float() for v in
                          sink["mlp_dslot_skipped_frac"]]).tolist()
        print(f"DSLOT: {len(vals)} digit-serial MLP calls, mean "
              f"{sum(vals) / len(vals):.1%} plane passes skipped "
              f"(D={args.n_planes} planes)")
    return toks


if __name__ == "__main__":
    main()
