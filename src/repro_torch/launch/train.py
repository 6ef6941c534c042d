"""Training entry point (port of ``repro.launch.train``, one device).

    python -m repro_torch.launch.train --arch olmo-1b [--reduced] --steps 100 \
        --ckpt-dir <dir> [--device cpu]

Wires together: config registry -> model zoo -> data pipeline ->
grad-accumulation train step -> loop with async checkpoints and
restore-on-start from the latest committed step.  Runs on ``--device``
(default ``cuda``; ``cpu`` runs the plain PyTorch versions).  The weights
come from a torch generator seeded 0 where the reference draws a JAX key,
so the numbers differ from the reference launcher's by the draw; a
checkpoint the reference wrote restores here, and the other way round.  As
in the reference, a restored run starts the token stream from its first
batch.  The reference's ``--devices`` / ``--mesh`` path belongs to the
port's multi-device slice.  Returns what it printed as a dict.
"""

import argparse


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.device import resolve_device
    from repro_torch.models.model_zoo import build_model
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.step import init_train_state, make_train_step

    dev = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)

    state = init_train_state(model, torch.Generator(dev).manual_seed(0),
                             device=dev)
    opt = AdamWConfig(peak_lr=args.lr, warmup_steps=min(100, args.steps // 10),
                      decay_steps=args.steps)
    step_fn = make_train_step(model, opt)

    pipe = TokenPipeline(vocab=cfg.vocab_size, seq_len=args.seq_len,
                         global_batch=args.global_batch,
                         microbatches=args.microbatches)

    out = {"restored": None, "log": []}
    ck = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
    if ck and ck.latest_step() is not None:
        state = ck.restore(ck.latest_step(), state)
        out["restored"] = int(state.step)
        print(f"restored from step {out['restored']}")

    out["params"] = model.param_count(state.params)
    print(f"arch={cfg.name} params={out['params']/1e6:.1f}M devices=1")

    start = int(state.step)
    for s in range(start, args.steps):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in pipe.next_host_batch().items()}
        state, m = step_fn(state, batch)
        if (s + 1) % args.log_every == 0 or s == start:
            row = {k: float(m[k]) for k in ("loss", "grad_norm", "lr")}
            out["log"].append((s + 1, row))
            print(f"step {s+1:5d}  loss {row['loss']:.4f}  "
                  f"gnorm {row['grad_norm']:.3f}  "
                  f"lr {row['lr']:.2e}", flush=True)
        if ck and (s + 1) % args.ckpt_every == 0:
            ck.save_async(s + 1, state)
    if ck:
        ck.wait()
        ck.save(args.steps, state)
    print("done.")
    return out


if __name__ == "__main__":
    main()
