"""Port parity for LM training (``repro_torch.optim.adamw``,
``repro_torch.train.step``, remat in ``models/transformer.py``, gradients
of ``models/model_zoo.loss_fn``) against the JAX reference
(``repro.optim.adamw``, ``repro.train.step``), on reduced configs on the
CPU.

The reference's own cases (``tests/test_train.py``) run on the port.
Inputs come from numpy seeds; reference parameters and optimizer states
cross over through ``repro_torch.convert``.  Tolerances, each stated where
it is used:

* optimizer functions on f32 trees within 1e-6 relative (the same f32 ops;
  XLA and PyTorch may fuse or order a sum differently);
* ``loss_fn`` gradients within 1e-5 of each leaf's largest reference
  entry, the loss within 1e-5 relative (XLA and PyTorch sum the same f32
  products in other orders, forward and backward);
* an AdamW step moves an entry by about ``lr * sign(g)``, so where a
  gradient is near zero the two packages may step in opposite directions:
  parameters are held within ``1e-3 * lr`` where the reference's |g|
  exceeds 1e-3 of its leaf's largest, and within ``2 * lr`` a step
  everywhere;
* remat on and off: equal gradients (the same ops run again on the CPU).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch_one_thread  # noqa: F401  (PyTorch on one CPU thread)

from repro.configs.registry import ARCHS as JARCHS
from repro.models.model_zoo import build_model as jbuild
from repro.models.model_zoo import loss_fn as jloss
from repro.optim import adamw as jadamw
from repro.train.step import init_train_state as jinit
from repro.train.step import make_train_step as jstep
from repro_torch import convert
from repro_torch.configs.registry import ARCHS
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.models import stats as tstats
from repro_torch.models.model_zoo import build_model
from repro_torch.optim.adamw import (AdamWConfig, adamw_update, global_norm,
                                     init_opt_state, schedule)
from repro_torch.train.step import (TrainState, init_train_state,
                                    make_train_step, microbatch_grads)
from repro_torch.tree import tree_map

from test_torch_models import cfg_pair, leaves, model_batch, ref_params, \
    to_np

OPT_RTOL = 1e-6
GRAD_REL = 1e-5


def t_batch(host: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in host.items()}


def clone(state):
    return tree_map(lambda a: a.clone(), state)


# ------------------------------------------- the reference's own cases

def test_loss_decreases():
    cfg = ARCHS["olmo-1b"].reduced()
    model = build_model(cfg)
    state = init_train_state(model, torch.Generator().manual_seed(0),
                             device="cpu")
    step = make_train_step(
        model, AdamWConfig(peak_lr=3e-3, warmup_steps=5, decay_steps=200))
    pipe = TokenPipeline(vocab=cfg.vocab_size, seq_len=32, global_batch=8,
                         microbatches=2)
    losses = []
    for _ in range(40):
        state, m = step(state, t_batch(pipe.next_host_batch()))
        losses.append(float(m["loss"]))
    assert min(losses[-5:]) < losses[0] - 0.4, (losses[0], losses[-5:])


def test_grad_accumulation_equivalent():
    """M=1 vs M=4 microbatches: same data -> (near-)identical update."""
    cfg = ARCHS["olmo-1b"].reduced()
    model = build_model(cfg)
    opt = AdamWConfig(peak_lr=1e-3, warmup_steps=0, decay_steps=10)
    step = make_train_step(model, opt)
    pipe = TokenPipeline(vocab=cfg.vocab_size, seq_len=16, global_batch=8,
                         microbatches=1)
    raw = t_batch(pipe.next_host_batch())
    b4 = {k: a.reshape(4, 2, *a.shape[2:]) for k, a in raw.items()}
    s0 = init_train_state(model, torch.Generator().manual_seed(0),
                          device="cpu")
    s1, m1 = step(clone(s0), raw)
    s4, m4 = step(s0, b4)
    assert abs(float(m1["loss"]) - float(m4["loss"])) < 1e-4
    diffs = [float((a.float() - b.float()).abs().max())
             for a, b in zip(leaves(s1.params), leaves(s4.params))]
    assert max(diffs) < 5e-3


def test_adamw_state_and_clipping():
    params = {"w": torch.ones((4, 4)), "b": torch.zeros((4,))}
    before = clone(params)
    opt = init_opt_state(params)
    big = {"w": torch.full((4, 4), 100.0), "b": torch.full((4,), 100.0)}
    cfg = AdamWConfig(clip_norm=1.0, warmup_steps=0, decay_steps=10,
                      peak_lr=0.1)
    newp, newopt, m = adamw_update(params, big, opt, cfg)
    assert float(m["grad_norm"]) > 1.0
    # clipped: effective step bounded by lr-ish magnitude
    assert float((newp["w"] - before["w"]).abs().max()) < 0.5
    assert int(newopt.count) == 1


def test_schedule_shape():
    cfg = AdamWConfig(peak_lr=1.0, warmup_steps=10, decay_steps=100,
                      min_lr_frac=0.1)
    lrs = [float(schedule(cfg, torch.tensor(s))) for s in
           [0, 5, 10, 50, 100, 1000]]
    assert lrs[1] < lrs[2]                       # warmup rises
    assert abs(lrs[2] - 1.0) < 1e-6              # peak
    assert lrs[3] < lrs[2]                       # decays
    assert abs(lrs[-1] - 0.1) < 1e-6             # floor


def test_global_norm():
    t = {"a": torch.tensor([3.0]), "b": torch.tensor([4.0])}
    assert abs(float(global_norm(t)) - 5.0) < 1e-6


# --------------------------------------------- parity: the optimizer

def rand_tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"w": (rng.normal(size=(16, 24)) * scale).astype(np.float32),
            "stack": [(rng.normal(size=(2, 8, 8)) * scale).astype(np.float32)],
            "norm": {"scale": (rng.normal(size=(24,)) * scale
                               ).astype(np.float32)}}


def assert_rel(port, ref, rtol, what=""):
    port = port.detach().float().numpy()
    ref = np.asarray(ref, np.float32)
    assert port.shape == ref.shape, what
    np.testing.assert_allclose(port, ref, rtol=0, err_msg=what,
                               atol=rtol * max(float(np.abs(ref).max()),
                                               1e-30))


@pytest.mark.parametrize("clip", [1.0, 100.0])
def test_adamw_update_schedule_global_norm_match_reference(clip):
    """Three updates from the same parameters and gradients (the first
    clipped when ``clip`` is 1): parameters, both moments, count,
    grad_norm and lr within ``OPT_RTOL`` relative; decay reaches only the
    2-D and 3-D leaves.  ``schedule`` at steps across warmup, decay and
    floor, and ``global_norm``, within ``OPT_RTOL``."""
    cfg = dict(peak_lr=0.05, warmup_steps=2, decay_steps=6, clip_norm=clip)
    jcfg, tcfg = jadamw.AdamWConfig(**cfg), AdamWConfig(**cfg)
    p = rand_tree(0)
    jp = jax.tree.map(jnp.asarray, p)
    tp = tree_map(torch.from_numpy, p)
    jopt, topt = jadamw.init_opt_state(jp), init_opt_state(tp)
    for k in range(3):
        g = rand_tree(10 + k, scale=3.0 if k == 0 else 0.1)
        assert_rel(global_norm(tree_map(torch.from_numpy, g)),
                   jadamw.global_norm(g), OPT_RTOL)
        jp, jopt, jm = jadamw.adamw_update(jp, jax.tree.map(jnp.asarray, g),
                                           jopt, jcfg)
        tp, topt, tm = adamw_update(tp, tree_map(torch.from_numpy, g), topt,
                                    tcfg)
        for name in ("grad_norm", "lr"):
            assert_rel(tm[name], jm[name], OPT_RTOL, name)
        assert int(topt.count) == int(jopt.count) == k + 1
        for tree_t, tree_j in ((tp, jp), (topt.m, jopt.m), (topt.v, jopt.v)):
            for a, b in zip(leaves(tree_t), jax.tree.leaves(tree_j)):
                assert_rel(a, b, OPT_RTOL)
    for s in (0, 1, 2, 3, 5, 6, 9):
        assert_rel(schedule(tcfg, torch.tensor(s, dtype=torch.int32)),
                   jadamw.schedule(jcfg, jnp.asarray(s, jnp.int32)),
                   OPT_RTOL, f"schedule({s})")


def test_adamw_keeps_bf16_params_bf16_and_decays_matrices_only():
    """The update runs in f32 and casts back to each parameter's dtype; a
    zero gradient leaves a 1-D leaf unchanged and shrinks a matrix by
    ``lr * weight_decay``, as in the reference."""
    p = {"m": torch.full((3, 3), 2.0, dtype=torch.bfloat16),
         "b": torch.full((3,), 2.0)}
    g = {"m": torch.zeros(3, 3), "b": torch.zeros(3)}
    cfg = AdamWConfig(peak_lr=0.5, warmup_steps=0, decay_steps=4)
    new, _, m = adamw_update(p, g, init_opt_state(p), cfg)
    ref, _, jm = jadamw.adamw_update(
        {"m": jnp.full((3, 3), 2.0, jnp.bfloat16), "b": jnp.full((3,), 2.0)},
        {"m": jnp.zeros((3, 3)), "b": jnp.zeros(3)},
        jadamw.init_opt_state({"m": jnp.zeros((3, 3)), "b": jnp.zeros(3)}),
        jadamw.AdamWConfig(peak_lr=0.5, warmup_steps=0, decay_steps=4))
    assert new["m"].dtype == torch.bfloat16
    np.testing.assert_array_equal(new["b"].numpy(), np.full(3, 2.0))
    np.testing.assert_array_equal(new["m"].float().numpy(),
                                  np.asarray(ref["m"], np.float32))
    assert float(new["m"][0, 0]) < 2.0


# ------------------------------------------- parity: the train step

def phase9_opt(steps=7, peak_lr=3e-4):
    """The launcher's wiring, as ``chip_smoke.py`` phase 9 uses it."""
    return dict(peak_lr=peak_lr, warmup_steps=min(100, steps // 10),
                decay_steps=steps)


def hold_params(port, ref, ref_grads, lr, what):
    """The AdamW rule of this file's docstring, per leaf."""
    for a, b, g in zip(leaves(port), jax.tree.leaves(ref),
                       jax.tree.leaves(ref_grads)):
        a = a.detach().float().numpy()
        b, g = np.asarray(b, np.float32), np.abs(np.asarray(g, np.float32))
        d = np.abs(a - b)
        assert d.max() <= 2 * lr * 1.0001, what
        firm = g > 1e-3 * g.max()
        assert firm.mean() > 0.5
        assert d[firm].max() <= 1e-3 * lr, (what, d[firm].max())


@pytest.mark.parametrize("n_steps", [1, 3])
def test_train_steps_match_reference(n_steps):
    """``train_step`` from ``convert.train_state`` of the reference's state,
    on the reference's pipeline batches (M = 2), against the reference's
    jitted step under phase 9's lr rule: every step's loss and grad_norm
    within ``GRAD_REL`` relative, lr within ``OPT_RTOL``; parameters after
    the first step by the AdamW rule, and after three within ``2 * lr`` a
    step; the reference's grads are taken on the first step's state."""
    jc, tc = cfg_pair("olmo-1b", n_layers=3, scan_unroll=1)
    opt = phase9_opt()
    js = jinit(jbuild(jc), jax.random.PRNGKey(0))
    ts = convert.train_state(to_np(js), device="cpu")
    assert isinstance(ts, TrainState) and ts.step.dtype == torch.int32
    jfn = jax.jit(jstep(jbuild(jc), jadamw.AdamWConfig(**opt)))
    tfn = make_train_step(build_model(tc), AdamWConfig(**opt))
    pipe = TokenPipeline(vocab=jc.vocab_size, seq_len=16, global_batch=4,
                         microbatches=2)
    first = pipe.next_host_batch()
    grads0 = jax.jit(jax.grad(lambda p: sum(
        jloss(jbuild(jc), p, jax.tree.map(lambda a: jnp.asarray(a[i]),
                                          first))[0] for i in range(2)) / 2))(
        js.params)
    batch = first
    for k in range(n_steps):
        js, jm = jfn(js, jax.tree.map(jnp.asarray, batch))
        ts, tm = tfn(ts, t_batch(batch))
        for name in ("loss", "grad_norm"):
            assert_rel(tm[name], jm[name], GRAD_REL, f"{name} step {k + 1}")
        assert_rel(tm["lr"], jm["lr"], OPT_RTOL)
        assert int(ts.step) == int(js.step) == k + 1
        batch = pipe.next_host_batch()
    lr = opt["peak_lr"]
    if n_steps == 1:
        hold_params(ts.params, js.params, grads0, lr, "step 1")
    else:
        for a, b in zip(leaves(ts.params), jax.tree.leaves(js.params)):
            assert float((a - torch.tensor(np.asarray(b))).abs().max()) \
                <= 2 * lr * n_steps
    for a, b in zip(leaves(ts.opt.v), jax.tree.leaves(js.opt.v)):
        assert_rel(a, b, 1e-4)


def port_grads(model, params, batch):
    """(loss, aux, gradient of the total per leaf in reference order) of
    one batch, through ``microbatch_grads`` with M = 1."""
    grads, ce, aux = microbatch_grads(
        model, params, tree_map(lambda a: a[None], batch))
    return ce, aux, leaves(grads)


def lm_batch(tc, B, S, seed):
    jb, tb = model_batch(tc, B, S, seed)
    labels = np.random.default_rng(seed + 9).integers(
        0, tc.vocab_size, (B, S)).astype(np.int32)
    labels[0, :3] = -1
    return ({**jb, "labels": jnp.asarray(labels)},
            {**tb, "labels": torch.from_numpy(labels).long()})


def hold_grads(port, ref, what):
    for i, (a, b) in enumerate(zip(port, ref)):
        b = np.asarray(b, np.float32)
        assert tuple(a.shape) == b.shape, (what, i)
        np.testing.assert_allclose(
            a.detach().float().numpy(), b, rtol=0, err_msg=f"{what} leaf {i}",
            atol=GRAD_REL * max(float(np.abs(b).max()), 1e-30))


def groups_and_rest(cfg) -> dict:
    """Depth and unroll that give a stack two remat groups (the pattern
    once, or twice for a one-kind pattern) and one rest layer."""
    P = len(cfg.block_pattern)
    unroll = 2 if P == 1 else 1
    return {"n_layers": 2 * P * unroll + 1, "scan_unroll": unroll}


@pytest.mark.parametrize("arch", sorted(JARCHS))
def test_loss_grads_match_reference_for_every_arch(arch):
    """``loss_fn``'s gradients under autograd against
    ``jax.value_and_grad``, for every architecture at reduced size with
    its pattern tiled twice into remat groups plus one rest layer (the
    enc-dec and frontend batches included): loss within ``GRAD_REL``
    relative, every leaf within ``GRAD_REL`` of its largest entry."""
    over = groups_and_rest(JARCHS[arch])
    if JARCHS[arch].window:
        over["window"] = 8                  # shorter than the sequence
    jc, tc = cfg_pair(arch, **over)
    jp, tp = ref_params(jc, seed=1)
    jb, tb = lm_batch(tc, 2, 12, seed=3)
    jm, tm = jbuild(jc), build_model(tc)
    assert tm.decoder.n_groups == 2 and tm.decoder.n_rest == 1

    (jtot, (jce, jaux)), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jloss(jm, p, b), has_aux=True))(
        jax.tree.map(jnp.asarray, jp), jb)
    ce, aux, tg = port_grads(tm, tp, tb)
    assert_rel(ce, jce, GRAD_REL, "loss")
    assert_rel(aux, jaux, GRAD_REL, "aux")
    hold_grads(tg, jax.tree.leaves(jg), arch)


@pytest.mark.parametrize("arch", ["olmo-1b", "granite-moe-1b-a400m",
                                  "recurrentgemma-2b", "seamless-m4t-medium"])
def test_remat_on_equals_off(arch):
    """Remat recomputes each group in the backward pass: the gradients, the
    loss and the MoE aux equal those without it, and the statistics sink
    gets each group's records once."""
    over = groups_and_rest(ARCHS[arch])
    on = dataclasses.replace(ARCHS[arch].reduced(), remat=True, **over)
    _, tp = ref_params(dataclasses.replace(JARCHS[arch].reduced(), **over),
                       seed=2)
    _, tb = lm_batch(on, 2, 12, seed=4)
    runs = []
    for cfg in (on, dataclasses.replace(on, remat=False)):
        with tstats.collect() as sink:
            ce, aux, g = port_grads(build_model(cfg), tp, tb)
        runs.append((ce, aux, g, {k: len(v) for k, v in sink.items()}))
    (ce1, aux1, g1, n1), (ce2, aux2, g2, n2) = runs
    assert torch.equal(ce1, ce2) and torch.equal(aux1, aux2) and n1 == n2
    for a, b in zip(g1, g2):
        assert torch.equal(a, b)
    if arch == "granite-moe-1b-a400m":
        assert float(aux1.detach()) > 0


def test_remat_stats_recorded_once_under_recompute():
    """A DSLOT ReLU MLP records termination statistics inside each group:
    under remat the backward pass recomputes the groups, and the sink still
    holds one stacked record per call, as without remat."""
    base = dataclasses.replace(ARCHS["olmo-1b"].reduced(), n_layers=3,
                               scan_unroll=1, act="relu", glu=False)
    from repro_torch.configs.base import DslotConfig
    cfg = dataclasses.replace(base, dslot=DslotConfig(
        enabled=True, block_m=16, block_n=32))
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    _, tb = lm_batch(cfg, 2, 8, seed=5)
    counts = []
    for remat in (True, False):
        m = build_model(dataclasses.replace(cfg, remat=remat))
        with tstats.collect() as sink:
            port_grads(m, params, tb)
        counts.append({k: [tuple(v.shape) for v in vals]
                       for k, vals in sink.items()})
    assert counts[0] == counts[1]
    assert counts[0]["mlp_dslot_planes_used"] == [(3,)]


def test_dslot_mlp_grads_match_reference_jnp_path():
    """Reduced olmo-1b with a ReLU, non-GLU DSLOT MLP: the plain path's
    gradients (the port on CPU tensors) against the reference's
    ``use_pallas=False`` ``_jnp_path``, within ``GRAD_REL`` of each leaf's
    largest; the up-projection's gradient is not zero."""
    dslot = dict(enabled=True, block_m=16, block_n=32)
    jc, tc = cfg_pair("olmo-1b", dslot=dslot, act="relu", glu=False)
    jp, tp = ref_params(jc, seed=6)
    jb, tb = lm_batch(tc, 2, 8, seed=7)
    (_, (jce, _)), jg = jax.jit(jax.value_and_grad(
        lambda p: jloss(jbuild(jc), p, jb), has_aux=True))(
        jax.tree.map(jnp.asarray, jp))
    ce, _, tg = port_grads(build_model(tc), tp, tb)
    assert_rel(ce, jce, GRAD_REL, "loss")
    hold_grads(tg, jax.tree.leaves(jg), "dslot")
    up = np.asarray(jg["decoder"]["rest"][0]["mlp"]["up"]["w"])
    assert np.abs(up).max() > 1e-3


def test_train_state_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = build_model(ARCHS["olmo-1b"].reduced())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_train_state(model, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.train_state(to_np(jinit(jbuild(JARCHS["olmo-1b"].reduced()),
                                        jax.random.PRNGKey(0))))
