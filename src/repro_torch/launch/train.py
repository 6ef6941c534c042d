"""Training entry point (port of ``repro.launch.train``).

    python -m repro_torch.launch.train --arch olmo-1b [--reduced] --steps 100 \
        --ckpt-dir <dir> [--devices 4 --mesh 2x2] [--device cpu]

Wires together: config registry -> model zoo -> FSDP x TP shardings -> data
pipeline -> grad-accumulation train step -> loop with async checkpoints and
restore-on-start from the latest committed step.  Runs on ``--device``
(default ``cuda``; ``cpu`` runs the plain PyTorch versions).  The weights
come from a torch generator seeded 0 where the reference draws a JAX key,
so the numbers differ from the reference launcher's by the draw; a
checkpoint the reference wrote restores here, and the other way round.  As
in the reference, a restored run starts the token stream from its first
batch.

``--devices N`` starts a world of N local ranks (``launch.mesh.run_world``):
over ``gloo`` on the CPU or where the ranks share one card, over ``nccl``
where each rank has a card of its own.  ``--mesh DxM`` names the (data,
model) mesh over them, as in the reference: the state is stored sharded by
``train.sharding``, each rank takes its slice of every batch
(``make_global_batch``) and runs ``make_sharded_train_step``, and
checkpoints are saved gathered and restored resharded.  Returns what rank 0
printed as a dict.
"""

import argparse

WORLD_TIMEOUT = 600            # seconds a collective may wait for a peer
WORLD_DEADLINE = 7 * 86400     # seconds a world may run


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
    ap.add_argument("--devices", type=int, default=0,
                    help="ranks of a local world")
    ap.add_argument("--mesh", default="", help="e.g. 4x2 = data x model")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if not args.devices:
        if args.mesh:
            raise ValueError("--mesh needs a world: pass --devices")
        return train(args)

    import torch

    from repro_torch.launch.mesh import run_world

    if args.device == "cpu":
        backend, device = "gloo", "cpu"
    elif args.device == "cuda" and torch.cuda.device_count() >= args.devices:
        backend, device = "nccl", "cuda"            # a card each
    else:                                           # the ranks share a card
        card = torch.device(args.device)
        backend, device = "gloo", f"cuda:{card.index or 0}"
    return run_world(_rank, args.devices, backend=backend, device=device,
                     timeout=WORLD_TIMEOUT, deadline=WORLD_DEADLINE,
                     args=(args,))[0]


def _rank(rank: int, args) -> dict:
    """One rank of a ``--devices`` world: ``train`` on this rank's device,
    printing on rank 0 only."""
    import torch

    dev = torch.device("cpu") if args.device == "cpu" else \
        torch.device("cuda", torch.cuda.current_device())
    return train(args, dev=dev, rank=rank)


def train(args, dev=None, rank: int = 0) -> dict:
    import torch

    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.pipeline import TokenPipeline, make_global_batch
    from repro_torch.device import resolve_device
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import pspec
    from repro_torch.models.model_zoo import build_model
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.sharding import (make_batch_shardings,
                                            make_state_shardings, shard_tree)
    from repro_torch.train.step import (init_train_state,
                                        make_sharded_train_step,
                                        make_train_step)

    def say(*a, **kw):
        if rank == 0:
            print(*a, **kw)

    dev = dev or resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)

    mesh = None
    if args.mesh:
        shape = tuple(int(x) for x in args.mesh.split("x"))
        names = ("data", "model")[-len(shape):]
        mesh = make_mesh(shape, names)
        pspec.set_mesh(mesh)

    state = init_train_state(model, torch.Generator(dev).manual_seed(0),
                             device=dev)
    opt = AdamWConfig(peak_lr=args.lr, warmup_steps=min(100, args.steps // 10),
                      decay_steps=args.steps)
    pipe = TokenPipeline(vocab=cfg.vocab_size, seq_len=args.seq_len,
                         global_batch=args.global_batch,
                         microbatches=args.microbatches)

    out = {"restored": None, "log": []}
    out["params"] = model.param_count(state.params)
    ssh = bsh = None
    if mesh is not None:
        ssh = make_state_shardings(mesh, state)
        cursor = pipe.state()
        bsh = make_batch_shardings(mesh, pipe.next_host_batch(),
                                   args.global_batch, batch_axis=1)
        pipe.restore(cursor)
        step_fn = make_sharded_train_step(model, opt, ssh)
    else:
        step_fn = make_train_step(model, opt)

    ck = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
    if ck and ck.latest_step() is not None:
        state = ck.restore(ck.latest_step(), state, ssh)
        out["restored"] = int(state.step)
        say(f"restored from step {out['restored']}")
    elif ssh is not None:
        state = shard_tree(state, ssh.specs, mesh)

    n_dev = 1 if mesh is None else mesh.size()
    say(f"arch={cfg.name} params={out['params']/1e6:.1f}M devices={n_dev}")

    start = int(state.step)
    for s in range(start, args.steps):
        host = pipe.next_host_batch()
        if mesh is not None:
            host = make_global_batch(mesh, host, bsh)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
        state, m = step_fn(state, batch)
        if (s + 1) % args.log_every == 0 or s == start:
            row = {k: float(m[k]) for k in ("loss", "grad_norm", "lr")}
            out["log"].append((s + 1, row))
            say(f"step {s+1:5d}  loss {row['loss']:.4f}  "
                f"gnorm {row['grad_norm']:.3f}  "
                f"lr {row['lr']:.2e}", flush=True)
        if ck and (s + 1) % args.ckpt_every == 0:
            ck.save_async(s + 1, state, ssh)
    if ck:
        ck.wait()
        ck.save(args.steps, state, ssh)
    pspec.set_mesh(None)
    say("done.")
    return out


if __name__ == "__main__":
    main()
