"""Rank bodies of ``test_torch_serve_split.py``: serving split over the model
axis (``pspec.model_shard``) on one ``gloo`` world per size.

Spawned ranks import this module, which imports only numpy, torch and
``repro_torch``: the test process makes the inputs from numpy seeds, runs
the unsplit port and the JAX reference, and hands the ranks numpy arrays.
``split_world`` runs every check of one world size and returns numpy
results.
"""

import numpy as np
import torch

from repro_torch.convert import model_params
from repro_torch.distributed import axis_rank, axis_size
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import pspec
from repro_torch.models.attention import KVCache, flash_attention
from repro_torch.models.model_zoo import build_model
from repro_torch.models.rglru import RGLRUState
from repro_torch.models.ssm import SSMState
from repro_torch.serve import Request, ServeConfig, ServeEngine
from repro_torch.train.sharding import model_slice
from repro_torch.tree import leaves


def t(a):
    a = np.array(a)
    return torch.as_tensor(a).long() if a.dtype == np.int32 else \
        torch.as_tensor(a)


def combine(case: dict, mesh) -> np.ndarray:
    """Every head's attention against the rank's block of the ring's
    slots, the ranks' online-softmax states joined by
    ``pspec.model_combine``."""
    n, r = axis_size(mesh, "model"), axis_rank(mesh, "model")
    C = case["k"].shape[1]
    blk = slice(r * (C // n), (r + 1) * (C // n))
    q, k, v = t(case["q"]), t(case["k"])[:, blk], t(case["v"])[:, blk]
    q_pos, k_pos = t(case["q_pos"]), t(case["k_pos"])[..., blk].int()
    with pspec.model_shard(mesh):
        m, l, acc = flash_attention(q, k, v, q_pos, k_pos,
                                    causal=case["causal"],
                                    window=case["window"],
                                    chunk=case["chunk"], partial=True)
        out = pspec.model_combine(m, l, acc, q.dtype)
    return out.reshape(q.shape).numpy()


def serve_sequence(model, params, batch: dict, max_len: int):
    """The serving entry points in turn: ``prefill`` of ragged prompts,
    ``decode_step``, a ragged ``extend`` and a full one.  Returns each one's
    logits (numpy) and the last state."""
    out = []
    logits, state = model.prefill(params, batch, max_len=max_len,
                                  lengths=t(np.array([6, 3], np.int32)))
    out.append(logits)
    logits, state = model.decode_step(params, state,
                                      t(np.array([[5], [9]], np.int32)))
    out.append(logits)
    chunk = t(np.random.default_rng(3).integers(0, 256, (2, 4))
              .astype(np.int32))
    logits, state = model.extend(params, state, chunk,
                                 lengths=t(np.array([4, 2], np.int32)))
    out.append(logits)
    logits, state = model.extend(params, state, chunk)
    out.append(logits)
    return [a.float().numpy() for a in out], state


def rings(state) -> list:
    """Every KV ring of a decode state, self and cross, in layer order: its
    class name and its k, v and positions (numpy)."""
    found = []

    def walk(node):
        if isinstance(node, KVCache):
            found.append((type(node).__name__,
                          *(a.float().numpy() if a.is_floating_point()
                            else a.numpy() for a in node)))
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)
    walk(state["caches"])
    return found


def recurrent(state) -> list:
    """Every recurrent state of a decode state in layer order: its class
    name and its fields (numpy)."""
    found = []

    def walk(node):
        if isinstance(node, (SSMState, RGLRUState)):
            found.append((type(node).__name__,
                          *(a.float().numpy() for a in node)))
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)
    walk(state["caches"])
    return found


def model_case(case: dict, mesh) -> dict:
    """A config's serving sequence on this rank's model slice inside
    ``pspec.model_shard``: its logits, its rings, and the share of the
    parameters the rank stores."""
    cfg = case["cfg"]
    model = build_model(cfg)
    whole = model_params(case["params"], device="cpu")
    mine = model_slice(mesh, cfg, whole)
    with pspec.model_shard(mesh, parts_cut=True):
        logits, state = serve_sequence(model, mine, {
            k: t(v) for k, v in case["batch"].items()}, case["max_len"])
    size = sum(a.numel() for a in leaves(mine))
    return dict(logits=logits, rings=rings(state),
                recurrent=recurrent(state),
                share=size / sum(a.numel() for a in leaves(whole)))


def engine_streams(cfg, params_np, traffic, mesh) -> dict:
    """``ServeEngine`` over ``mesh`` (None: unsplit) on ``traffic``: each
    request's greedy stream and ``planes_used_mean``, and the pool's
    rings."""
    pspec.set_mesh(None)                   # the engine installs its own mesh
    eng = ServeEngine(build_model(cfg), model_params(params_np, device="cpu"),
                      ServeConfig(n_slots=2, max_len=32, prefill_chunk=4,
                                  chunks_per_step=2, mesh=mesh))
    reqs = [Request(uid=i, prompt=np.asarray(p, np.int32), max_new=new,
                    n_planes=b) for i, (p, new, b) in enumerate(traffic)]
    for r in reqs:
        assert eng.try_add(r)
    for _ in range(300):
        if all(r.done for r in reqs):
            break
        eng.step()
    assert all(r.done for r in reqs)
    out = dict(streams=[(list(map(int, r.out)), r.result.planes_used_mean)
                        for r in reqs], rings=rings(eng.state),
               recurrent=recurrent(eng.state))
    pspec.set_mesh(None)
    return out


def other_axis(cfg, params_np, mesh) -> str:
    """The error of a ``ServeEngine`` over ``mesh`` asked to split over
    its "data" axis ("" where it builds)."""
    try:
        ServeEngine(build_model(cfg), model_params(params_np, device="cpu"),
                    ServeConfig(n_slots=2, max_len=32, mesh=mesh,
                                tp_axis="data"))
    except ValueError as e:
        return str(e)
    finally:
        pspec.set_mesh(None)
    return ""


def split_world(rank, n, combines, models, engine, hybrid):
    """Every check of a world of ``n`` ranks over a (1, n) mesh: the
    softmax combine, each config's serving sequence, the engine and the
    hybrid's engine."""
    mesh = make_test_mesh(model=n)
    cfg, params_np, traffic = engine
    return dict(rank=rank,
                combine=[combine(c, mesh) for c in combines],
                models={name: model_case(c, mesh)
                        for name, c in models.items()},
                engine=engine_streams(cfg, params_np, traffic, mesh),
                hybrid=engine_streams(*hybrid, mesh),
                other_axis=other_axis(cfg, params_np, mesh))
