"""End-to-end training driver: a 50.3M-parameter LM for a few hundred steps
(port of ``examples/train_lm.py``, whose docstring calls it ~100M).

The olmo family scaled down to 8 layers x 512 (vocab 32768, f32), the
structured token stream at seq 256, batch 8 in 2 microbatches, AdamW at
peak lr 1e-3 with 20 warmup steps, and an async checkpoint every 50 steps
(the last 2 kept).

    python -m repro_torch.launch.train_lm [--steps 200] [--device cpu]

Runs on ``--device`` (default ``cuda``).  The weights come from a torch
generator seeded 0 where the example draws a JAX key, so the losses differ
from the example's by the draw.  Returns what it printed as a dict.
"""

import argparse
import dataclasses
import os
import tempfile
import time

SEQ_LEN, GLOBAL_BATCH, MICROBATCHES = 256, 8, 2


def config():
    """The example's olmo-family model."""
    from repro_torch.configs.registry import get_arch

    return dataclasses.replace(
        get_arch("olmo-1b"),
        n_layers=8, d_model=512, n_heads=8, n_kv_heads=8, d_ff=2048,
        vocab_size=32_768, scan_unroll=2, attn_chunk=128, dtype="float32")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.device import resolve_device
    from repro_torch.models.model_zoo import build_model
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.step import init_train_state, make_train_step

    dev = resolve_device(args.device)
    cfg = config()
    model = build_model(cfg)
    state = init_train_state(model, torch.Generator(dev).manual_seed(0),
                             device=dev)
    n = model.param_count(state.params)
    print(f"model: {cfg.n_layers}L d{cfg.d_model} -> {n/1e6:.1f}M params")

    opt = AdamWConfig(peak_lr=1e-3, warmup_steps=20, decay_steps=args.steps)
    step_fn = make_train_step(model, opt)
    pipe = TokenPipeline(vocab=cfg.vocab_size, seq_len=SEQ_LEN,
                         global_batch=GLOBAL_BATCH, microbatches=MICROBATCHES)
    ck = Checkpointer(args.ckpt_dir, keep=2)

    out = {"params": n, "log": []}
    t0 = time.time()
    for s in range(args.steps):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in pipe.next_host_batch().items()}
        state, m = step_fn(state, batch)
        if (s + 1) % 10 == 0 or s == 0:
            rate = GLOBAL_BATCH * SEQ_LEN * (s + 1) / (time.time() - t0)
            row = {"loss": float(m["loss"]),
                   "grad_norm": float(m["grad_norm"]), "tok_s": rate}
            out["log"].append((s + 1, row))
            print(f"step {s+1:4d}  loss {row['loss']:.4f}  "
                  f"gnorm {row['grad_norm']:.2f}  {rate:.0f} tok/s",
                  flush=True)
        if (s + 1) % 50 == 0:
            ck.save_async(s + 1, state)
    ck.wait()
    out["steps"] = ck.all_steps()
    print(f"done in {time.time()-t0:.0f}s; checkpoints in {args.ckpt_dir}")
    return out


if __name__ == "__main__":
    main()
