"""Rank bodies of the port's multi-process tests
(``test_torch_tensor_parallel.py``, ``test_torch_distributed.py``).

Spawned ranks import this module, which imports only numpy, torch and
``repro_torch``: the test process makes the inputs from numpy seeds, runs
the JAX reference, and hands the ranks numpy arrays.  Each world function
runs every check of one world size and returns numpy results.
"""

import dataclasses

import numpy as np
import torch

from repro_torch.convert import model_params
from repro_torch.distributed import axis_rank
from repro_torch.distributed.expert_parallel import apply_moe_ep
from repro_torch.distributed.overlap import (collective_matmul_ag,
                                             plain_matmul_ag)
from repro_torch.kernels.ops import dslot_execute, dslot_prepare
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.layers import DslotConv2d, DslotDense
from repro_torch.models import pspec
from repro_torch.models.model_zoo import build_model
from repro_torch.models.moe import apply_moe
from repro_torch.serve import (QUARANTINED, Fault, FaultPlan, Request,
                               ServeConfig, ServeEngine, audit_engine)

# (n_kv, n_heads) pairs for head_scheme: kv-sharded, group-sharded, repeat
HEAD_CASES = ((4, 8), (2, 8), (1, 8), (3, 9))


def t(a):
    return torch.as_tensor(np.asarray(a))


def stats_np(res) -> dict:
    out, st = res
    return dict(out=out.numpy(), planes_used=st.planes_used.numpy(),
                planes_bounded=st.planes_bounded.numpy(),
                row_planes_used=st.row_planes_used.numpy(),
                skipped_frac=float(st.skipped_frac), n_planes=st.n_planes)


def execute_pair(case: dict, mesh) -> dict:
    """One case through the port's unsharded and sharded execute."""
    w, x, kw = t(case["w"]), t(case["x"]), case["kw"]
    npl = case["npl"]
    npl = t(npl) if isinstance(npl, np.ndarray) else npl
    whole = dslot_prepare(w, **kw)
    mine = dslot_prepare(w, mesh=mesh, **kw)
    return dict(plain=stats_np(dslot_execute(whole, x, n_planes=npl)),
                sharded=stats_np(dslot_execute(mine, x, n_planes=npl)),
                bytes=(mine.w.numel(), whole.w.numel()))


LAYERS = ((DslotDense, dict(d_in=48, d_out=80, block_m=16, block_n=16,
                            block_k=16, sort_columns=True)),
          (DslotConv2d, dict(in_channels=4, out_channels=40, kernel_size=3,
                             padding="same", block_m=16, block_n=16)))


def layer_pairs(layers_np, mesh) -> list:
    """``DslotDense`` and ``DslotConv2d`` with and without ``mesh``: are
    the outputs and ``planes_used`` equal?"""
    flags = []
    for (cls, kw), (w, x) in zip(LAYERS, layers_np):
        plain = cls(**kw)
        mine = dataclasses.replace(plain, mesh=mesh)
        y0, s0 = plain.apply(plain.prepare({"w": t(w)}), t(x), n_planes=6)
        y1, s1 = mine.apply(mine.prepare({"w": t(w)}), t(x), n_planes=6)
        flags.append(torch.equal(y0, y1)
                     and torch.equal(s0.planes_used, s1.planes_used))
    return flags


def pspec_sizes(mesh) -> tuple:
    pspec.set_mesh(mesh)
    try:
        return (pspec.tp_size(), pspec.fsdp_size(),
                tuple(pspec.head_scheme(k, h) for k, h in HEAD_CASES))
    finally:
        pspec.set_mesh(None)


# ------------------------------------------------------------ the engine

def burst(cfg, params_np, prompts, budgets, mesh, max_new=6):
    """The reference's ``test_sharded_serve_engine_token_identical`` burst:
    every prompt at step 0 with its own plane budget."""
    pspec.set_mesh(None)                   # the engine installs its own mesh
    eng = ServeEngine(build_model(cfg), model_params(params_np, device="cpu"),
                      ServeConfig(n_slots=2, max_len=64, prefill_chunk=4,
                                  mesh=mesh))
    reqs = [Request(uid=i, prompt=np.asarray(p, np.int32), max_new=max_new,
                    n_planes=b) for i, (p, b) in enumerate(zip(prompts,
                                                               budgets))]
    for r in reqs:
        assert eng.try_add(r)
    for _ in range(300):
        if all(r.done for r in reqs):
            break
        eng.step()
    assert all(r.done for r in reqs)
    return [(list(map(int, r.out)), r.result.planes_used_mean) for r in reqs]


def chaos(cfg, params_np, surv_p, vict_p, mesh):
    """The reference's ``test_sharded_chaos_quarantine_isolation``: a NaN
    injected into the victim's logits at step 5 quarantines exactly the
    victim; the survivor's stream equals a run that never admitted it."""
    model, params = build_model(cfg), model_params(params_np, device="cpu")

    def run(with_victim, faults):
        pspec.set_mesh(None)
        eng = ServeEngine(model, params, ServeConfig(
            n_slots=2, max_len=64, prefill_chunk=4, mesh=mesh,
            faults=faults))
        surv = Request(uid=1, prompt=np.asarray(surv_p, np.int32), max_new=8)
        assert eng.try_add(surv)
        vict = None
        if with_victim:
            vict = Request(uid=2, prompt=np.asarray(vict_p, np.int32),
                           max_new=8)
            assert eng.try_add(vict)
        audits = []
        for _ in range(100):
            eng.step()
            audits += audit_engine(eng)
            if surv.done and (vict is None or vict.done):
                break
        return eng, surv, vict, audits

    plan = FaultPlan(faults=(Fault(kind="nan_logits", step=5, uid=2),))
    eng, surv, vict, audits = run(True, plan)
    _, ref, _, ref_audits = run(False, None)
    return dict(victim_phase=vict.phase, victim_done=vict.done,
                quarantined=[u for _, u in eng.quarantined],
                survivor_phase=surv.phase, survivor=list(surv.out),
                alone=list(ref.out), audits=audits + ref_audits,
                quarantined_phase=QUARANTINED)


def lone_gather(rank, wait):
    """Rank 0 posts an ``all_gather`` that rank 1 never posts: rank 1
    sleeps ``wait`` seconds (past the timeout) and returns."""
    import time

    from repro_torch.distributed import all_gather
    mesh = make_test_mesh(model=2)
    if rank == 0:
        all_gather(torch.ones(4), mesh, "model", dim=0)
    else:
        time.sleep(wait)
    return rank


def tp_world(rank, n, cases, layers_np, engine):
    """Every tensor-parallel check of a world of ``n`` ranks: the execute
    cases and the layers over (1, n) (and, at n = 4, over the (2, 2) mesh's
    model axis), the pspec sizes, the engine burst sharded and unsharded,
    and (n = 2) the chaos mirror."""
    meshes = {n: make_test_mesh(model=n)}
    if n == 4:
        meshes[2] = make_test_mesh(model=2)
    out = dict(rank=rank, pspec={s: pspec_sizes(m) for s, m in
                                 meshes.items()})
    out["timeouts"] = {s: [m.get_group(a)._get_backend(torch.device("cpu"))
                           .options._timeout.total_seconds()
                           for a in m.mesh_dim_names]
                       for s, m in meshes.items()}
    out["execute"] = {s: [execute_pair(c, m) for c in cases]
                      for s, m in meshes.items()}
    out["layers"] = {s: layer_pairs(layers_np, m) for s, m in meshes.items()}
    cfg, params_np, prompts, budgets = engine
    out["engine"] = burst(cfg, params_np, prompts, budgets, meshes[n])
    out["engine_plain"] = burst(cfg, params_np, prompts, budgets, None)
    if n == 2:
        out["chaos"] = chaos(cfg, params_np, prompts[0], prompts[1],
                             meshes[n])
    pspec.set_mesh(None)
    return out


def card_execute(rank, cases):
    """Each case sharded over the ranks sharing the card and unsharded on
    the same card (the CUDA kernel): which results are equal."""
    mesh = make_test_mesh(model=2)
    dev = torch.device("cuda", torch.cuda.current_device())
    flags = []
    for case in cases:
        w = t(case["w"]).to(dev, getattr(torch, case.get("wdtype",
                                                          "float32")))
        x = t(case["x"]).to(dev)
        npl = case["npl"]
        npl = t(npl).to(dev) if isinstance(npl, np.ndarray) else npl
        a = stats_np(_cpu(dslot_execute(dslot_prepare(w, **case["kw"]), x,
                                        n_planes=npl)))
        b = stats_np(_cpu(dslot_execute(
            dslot_prepare(w, mesh=mesh, **case["kw"]), x, n_planes=npl)))
        flags.append({k: bool(np.array_equal(a[k], b[k])) for k in a})
    return flags


def _cpu(res):
    out, st = res
    return out.cpu(), st._replace(**{
        f: getattr(st, f).cpu() for f in ("planes_used", "skipped_frac",
                                          "row_planes_used",
                                          "planes_bounded")})


# ------------------------------------------------- expert parallel, overlap

def moe_params(p_np):
    return {k: t(v) for k, v in p_np.items()}


def _np_moe(res):
    y, aux = res
    return y.numpy(), float(aux)


def ep_world(rank, n, moe, matmul, groups):
    """Every check of ``test_torch_distributed.py`` in a world of ``n``:
    expert parallelism over (1, n) with and without plane budgets, the
    collective matmul over (1, n), expert parallelism where its capacity
    rule differs from ``apply_moe``'s, and (n = 4) dispatch groups on the
    (2, 2) mesh: ``apply_moe`` with G = 2 and expert parallelism over its
    model axis."""
    mesh = make_test_mesh(model=n)
    cfg, p_np, x_np, lo = moe
    p, x = moe_params(p_np), t(x_np)
    y, aux = apply_moe_ep(p, x, cfg, mesh)
    full = torch.full((cfg.n_experts,), 8, dtype=torch.int32)
    y_full, _ = apply_moe_ep(p, x, cfg, mesh, expert_planes=full)
    y_lo, _ = apply_moe_ep(p, x, cfg, mesh, expert_planes=t(lo))
    y_lo2, _ = apply_moe_ep(p, x, cfg, mesh, expert_planes=t(lo))
    out = dict(y=y.numpy(), aux=float(aux), y_full=y_full.numpy(),
               y_lo=y_lo.numpy(), y_lo2=y_lo2.numpy())

    X, W = t(matmul[0]), t(matmul[1])
    j = axis_rank(mesh, "model")
    rows, cols = X.shape[0] // n, W.shape[1] // n
    xl, wl = X[j * rows:(j + 1) * rows], W[:, j * cols:(j + 1) * cols]
    out["cm"] = (j, collective_matmul_ag(xl, wl, mesh).numpy(),
                 plain_matmul_ag(xl, wl, mesh).numpy())

    gcfg, gp_np, gx_np, capacity_x = groups
    gp = moe_params(gp_np)
    out["capacity"] = {k: _np_moe(apply_moe_ep(gp, t(v), gcfg, mesh))
                       for k, v in capacity_x.items()}
    if n == 4:
        mesh22 = make_test_mesh(model=2)
        gx = t(gx_np)
        pspec.set_mesh(mesh22)
        try:
            yg, auxg = apply_moe(gp, gx, gcfg)             # G = 2
        finally:
            pspec.set_mesh(None)
        d = axis_rank(mesh22, "data")
        half = gx.shape[0] // 2
        ye, auxe = apply_moe_ep(gp, gx[d * half:(d + 1) * half], gcfg,
                                mesh22)
        out["groups"] = dict(y=yg.numpy(), aux=float(auxg), data=d,
                             y_ep=ye.numpy(), aux_ep=float(auxe))
    return out


# ------------------------------------------------------------ prepared parts

def mixed_vote_case():
    """One N tile of 128 columns over 8 vote tiles of 16 rows: mostly
    negative W and q rows of one sign per vote tile, alternating, the
    positive tiles at falling magnitudes, so that they die at different
    planes and the negative ones never do."""
    rng = np.random.default_rng(11)
    M, K, N = 128, 128, 128
    w = rng.normal(-0.02, 0.01, (K, N)).astype(np.float32)
    sign = np.repeat([1.0, -1.0] * 4, 16)[:, None]
    scale = np.repeat([1.0, 1.0, 0.12, 1.0, 0.5, 1.0, 0.25, 1.0], 16)[:, None]
    x = (sign * scale * rng.uniform(0.5, 1.0, (M, K))).astype(np.float32)
    return x, w



def prepared_parts_cases(rank, cases):
    """This rank's prepared W parts of each (weights, prepare keywords)
    layer split over (1, 2), with the column range its tiles cover in the
    unsharded padded layout."""
    mesh = make_test_mesh(model=2)
    out = []
    for w_np, kw in cases:
        prep = dslot_prepare(t(w_np), mesh=mesh, **kw)
        tiles = prep.w.shape[1] // prep.block_n
        out.append(dict(parts=prep.parts.float().numpy(),
                        cols=(rank * tiles * prep.block_n,
                              (rank + 1) * tiles * prep.block_n)))
    return dict(rank=rank, cases=out)
