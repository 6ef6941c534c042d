"""Port parity for the rest of the model zoo (``repro_torch.models``:
sliding-window attention, MoE, the mamba2 SSD mixer, RG-LRU, ``loss_fn``)
and for the serving lanes over recurrent state, against the JAX reference
(``repro.models``, ``repro.serve``), on reduced configs.

Inputs come from numpy seeds; reference parameters cross over through
``repro_torch.convert.model_params``.  The cases mirror the reference's own
tests: ``test_moe.py``, the deterministic cases of ``test_ssm_rglru.py``,
the SWA cases of ``test_attention_batched.py``, ``test_decode.py`` and the
recurrent lanes of ``test_serve_prefill.py``.

Tolerances: integer results (expert choices, ``keep``, slots, capacities,
conv-tail gathers, ring positions, tokens) exact; f32 outputs within
``1e-4 * max|reference|`` (``test_torch_models.REL``): XLA and PyTorch sum
the same f32 products in other orders, and the RG-LRU scan composes its
pairs in another tree than ``jax.lax.associative_scan``.  Padded ==
trimmed and zero-length rows are held to the reference's own bounds
(bitwise where the reference's test is bitwise).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch_one_thread  # noqa: F401  (PyTorch on one CPU thread)

import repro.serve as jserve
import repro_torch.serve as tserve
from repro.models import attention as jatt
from repro.models import moe as jmoe
from repro.models import rglru as jrg
from repro.models import ssm as jssm
from repro.models.model_zoo import build_model as jbuild
from repro.models.model_zoo import loss_fn as jloss
from repro_torch.convert import model_params
from repro_torch.models import attention as tatt
from repro_torch.models import moe as tmoe
from repro_torch.models import rglru as trg
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttr
from repro_torch.models.model_zoo import build_model as tbuild
from repro_torch.models.model_zoo import loss_fn as tloss
from repro_torch.serve.engine import _merge_slot
from repro_torch.serve.prefill import _batch_axes, extract_row, insert_row

from test_torch_models import (attn_params, cfg_pair, close, leaves,
                               ref_params, rng_normal, run_attention,
                               same_cache, same_state, t, to_np)

NEW_ARCHS = ("h2o-danube-3-4b", "granite-moe-1b-a400m", "mamba2-780m",
             "recurrentgemma-2b", "mixtral-8x22b")


def q_valid(lens, S):
    return np.arange(S)[None] < np.asarray(lens)[:, None]


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_params_carry_over_with_reference_layout(arch):
    """``convert.model_params`` carries every leaf of the reference's tree
    (f32 router, ``A_log``, ``D_skip``, ``lam`` stay f32), and the port's own
    init has the same leaves, shapes and dtypes."""
    jc, tc = cfg_pair(arch, dtype="bfloat16")
    jp, tp = ref_params(jc)
    own = tbuild(tc).init(torch.Generator().manual_seed(0), device="cpu")
    jl = jax.tree.leaves(jp)
    assert [(tuple(a.shape), a.dtype) for a in leaves(tp)] == \
        [(tuple(a.shape), a.dtype) for a in leaves(own)]
    assert [tuple(a.shape) for a in leaves(tp)] == [b.shape for b in jl]
    names = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    assert [a.dtype for a in leaves(tp)] == [names[b.dtype.name] for b in jl]
    assert torch.float32 in {a.dtype for a in leaves(tp)}


# ------------------------------------------------------ sliding window

@pytest.mark.parametrize("S,q_chunk,window", [(40, 16, 32), (37, 8, 12),
                                              (9, 16, 4)])
def test_swa_attention_matches_reference(S, q_chunk, window):
    rng = np.random.default_rng(S)
    q = rng.normal(size=(2, S, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, S, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, S, 2, 16)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)
    ref = jatt.swa_attention(*map(jnp.asarray, (q, k, v, pos, pos)),
                             window=window, q_chunk=q_chunk)
    out = tatt.swa_attention(*map(t, (q, k, v, pos, pos)), window=window,
                             q_chunk=q_chunk)
    close(out, ref)


def test_swa_prefill_and_carry_window_extension_across_a_wrap():
    """A ragged prefill builds window-sized rings, then ragged chunks land
    across the ring's wrap: each attends against the pre-write ring beside
    its own keys (pad rows' chunk keys masked).  Outputs, ring contents and
    ring positions match the reference; the input ring is left as it
    was."""
    jc, tc = cfg_pair("h2o-danube-3-4b", window=8)
    jp, tp = attn_params(jc, 3)
    x = rng_normal(4, (3, 11, 64))
    pos = np.arange(11, dtype=np.int32)
    jcache, tcache = run_attention(jp, tp, jc, tc, x, pos,
                                   q_valid=q_valid((11, 6, 0), 11),
                                   return_cache=True, cache_len=64)
    same_cache(jcache, tcache)
    assert tcache.k.shape[1] == 8
    depth = np.array([11, 6, 0])
    for step, (S, lens) in enumerate(((5, (5, 3, 0)), (6, (6, 6, 2)))):
        chunk_pos = (depth[:, None] + np.arange(S)[None]).astype(np.int32)
        xc, qv = rng_normal(5 + step, (3, S, 64)), q_valid(lens, S)
        jcache, tnew = run_attention(
            jp, tp, jc, tc, xc, chunk_pos,
            cache=tuple(np.asarray(a) for a in jcache), q_valid=qv)
        same_cache(jcache, tnew)
        # the port's own ring, extended the same way, is left as it was
        kept = [a.clone() for a in tcache]
        tatt.attention_forward(tp, t(xc), tc, positions=t(chunk_pos),
                               cache=tcache, q_valid=t(qv))
        assert all(torch.equal(a, b) for a, b in zip(tcache, kept))
        tcache = tnew
        depth = depth + np.asarray(lens)


def test_swa_chunked_extension_matches_whole_prompt_prefill():
    """The reference's own SWA invariant, port against reference: a prompt
    longer than the window, extended chunk by chunk, gives the logits and
    rings of the one-shot prefill (``test_attention_batched.py``)."""
    jc, tc = cfg_pair("h2o-danube-3-4b")                # window 32 reduced
    jm, tm = jbuild(jc), tbuild(tc)
    jp, tp = ref_params(jc, seed=5)
    jp = jax.tree.map(jnp.asarray, jp)
    p = np.random.RandomState(11).randint(0, 256, size=40).astype(np.int32)
    tl_ref, tst_ref = tm.prefill(tp, {"tokens": t(p[None]).long()},
                                 max_len=48)
    jl_ref, jst_ref = jm.prefill(jp, {"tokens": jnp.asarray(p[None])},
                                 max_len=48)
    close(tl_ref, jl_ref)
    same_state(jst_ref, tst_ref, tm.decoder)
    st = tm.init_decode_state(1, 48, device="cpu")
    for o in range(0, 40, 8):
        tl, st = tm.extend(tp, st, t(p[None, o:o + 8]).long())
    close(tl, jl_ref)
    same_state(jst_ref, st, tm.decoder)


def test_swa_ring_decode_past_the_window_matches_reference():
    """Decode far past the window (``test_decode.py``): ring slots recycle,
    old positions drop out of the mask, and every step's logits match."""
    jc, tc = cfg_pair("h2o-danube-3-4b", window=8)
    jm, tm = jbuild(jc), tbuild(tc)
    jp, tp = ref_params(jc, seed=1)
    jp = jax.tree.map(jnp.asarray, jp)
    toks = np.random.default_rng(1).integers(0, 256, (2, 6)).astype(np.int32)
    jl, jst = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, max_len=64)
    tl, tst = tm.prefill(tp, {"tokens": t(toks).long()}, max_len=64)
    close(tl, jl)
    for step in range(14):
        tok = np.full((2, 1), step * 7 % 256, np.int32)
        jl, jst = jm.decode_step(jp, jst, jnp.asarray(tok))
        tl, tst = tm.decode_step(tp, tst, t(tok).long())
        close(tl, jl)
    same_state(jst, tst, tm.decoder)


# ------------------------------------------------------ mixture of experts

def moe_pair(**over):
    jc, tc = cfg_pair("granite-moe-1b-a400m", **over)
    p = to_np(jmoe.init_moe(jc, jax.random.PRNGKey(0)))
    return jc, tc, p, model_params(p, device="cpu")


def ref_route(p, x, cfg, C):
    """The reference's dispatch plan (``_moe_block``'s routing lines)."""
    flat = jnp.asarray(x).reshape(1, -1, x.shape[-1])
    probs = jax.nn.softmax(jnp.einsum("gtd,de->gte", flat.astype(jnp.float32),
                                      jnp.asarray(p["router"])), axis=-1)
    _, idx = jax.lax.top_k(probs, cfg.top_k)
    onehot = jax.nn.one_hot(idx, cfg.n_experts, dtype=jnp.float32)
    choice = onehot.reshape(1, -1, cfg.n_experts)
    rank = jnp.sum((jnp.cumsum(choice, axis=1) - choice) * choice,
                   axis=-1).reshape(idx.shape)
    keep = rank < C
    slot = idx * C + jnp.minimum(rank, C - 1).astype(jnp.int32)
    return [np.asarray(a) for a in (idx, keep, slot)]


@pytest.mark.parametrize("case,B,S,over", [
    ("dropless", 2, 8, {}),
    ("capacity drops", 2, 256, dict(capacity_factor=0.25)),
    ("decode", 4, 1, dict(capacity_factor=0.25)),
    ("two token blocks", 2, 4096, dict(d_model=16, d_ff=32,
                                       capacity_factor=0.5))])
def test_moe_matches_reference(case, B, S, over):
    """Outputs and aux; the expert choices, ``keep`` and slots exactly.
    Capacities are 128-aligned, so choices drop only where an expert gets
    more than 128 of a block's (token, choice) pairs.  Decode (S == 1)
    takes capacity T*K, dropless whatever the factor; 8192 tokens stream
    through two blocks of 4096 (aux = mean over blocks)."""
    jc, tc, jp, tp = moe_pair(**over)
    x = rng_normal(B * S, (B, S, tc.d_model), 0.5)
    ref, jaux = jmoe.apply_moe(jax.tree.map(jnp.asarray, jp),
                               jnp.asarray(x), jc)
    out, aux = tmoe.apply_moe(tp, t(x), tc)
    close(out, ref)
    close(aux, jaux)
    T = B * S
    blocks = 2 if case == "two token blocks" else 1
    Tl = T // blocks
    C = Tl * tc.top_k if S == 1 else tmoe.moe_capacity(tc, Tl)
    dropped = 0
    for i in range(blocks):
        xb = x.reshape(T, -1)[i * Tl:(i + 1) * Tl]
        want = ref_route(jp, xb, jc, C)
        _, _, idx, keep, slot = tmoe.route(tp, t(xb)[None], tc, C)
        for a, b in zip((idx, keep, slot), want):
            np.testing.assert_array_equal(a.numpy(), b)
        dropped += int((~keep).sum())
    assert (dropped > 0) == (case in ("capacity drops", "two token blocks"))


def test_moe_capacity_and_tie_breaking_match_reference():
    """``moe_capacity`` is the reference's (128-aligned) at every size; a
    router with equal probabilities picks the lowest experts, in order, as
    ``jax.lax.top_k`` does."""
    jc, tc, jp, tp = moe_pair()
    for n in (1, 4, 100, 4096, 8192, 50_000):
        for cf in (0.25, 1.0, 1.25, 4.0):
            tcf = dataclasses.replace(tc, capacity_factor=cf)
            jcf = dataclasses.replace(jc, capacity_factor=cf)
            assert tmoe.moe_capacity(tcf, n) == jmoe.moe_capacity(jcf, n)
    tp = {**tp, "router": torch.zeros_like(tp["router"])}
    jp = {**jp, "router": np.zeros_like(jp["router"])}
    x = rng_normal(1, (6, tc.d_model))
    _, _, idx, keep, slot = tmoe.route(tp, t(x)[None], tc, 16)
    want = ref_route(jp, x, jc, 16)
    np.testing.assert_array_equal(idx.numpy(), want[0])
    assert idx[0, 0].tolist() == list(range(tc.top_k))
    np.testing.assert_array_equal(slot.numpy(), want[2])


def test_loss_fn_with_aux_matches_reference():
    """Next-token CE with masked labels plus ``aux_weight`` times the MoE
    aux, on a reduced MoE model; the reference's loss and aux."""
    jc, tc = cfg_pair("granite-moe-1b-a400m")
    jp, tp = ref_params(jc, seed=2)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, 256, (2, 9)).astype(np.int32)
    labels = rng.integers(0, 256, (2, 9)).astype(np.int32)
    labels[0, :3] = -1
    labels[1, -1] = -1
    jtot, (jl, ja) = jloss(jbuild(jc), jax.tree.map(jnp.asarray, jp),
                           {"tokens": jnp.asarray(toks),
                            "labels": jnp.asarray(labels)}, aux_weight=0.5)
    ttot, (tl, ta) = tloss(tbuild(tc), tp, {"tokens": t(toks).long(),
                                            "labels": t(labels).long()},
                           aux_weight=0.5)
    assert float(ja) > 0.5
    for a, b in ((ttot, jtot), (tl, jl), (ta, ja)):
        close(a, b)


# ------------------------------------------------------ mamba2 SSD

def test_causal_conv_ragged_tails_match_reference():
    """Per-row tails gather each row's last k-1 valid inputs (a zero-length
    row keeps its incoming tail bitwise); outputs match the reference."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(4, 6, 10)).astype(np.float32)
    w = rng.normal(size=(4, 10)).astype(np.float32) * 0.3
    b = rng.normal(size=(10,)).astype(np.float32) * 0.1
    tail = rng.normal(size=(4, 3, 10)).astype(np.float32)
    lengths = np.array([6, 2, 0, 5], np.int32)
    for tl, ln in ((None, None), (tail, None), (tail, lengths),
                   (None, lengths)):
        jy, jt = jssm._causal_conv(
            *map(jnp.asarray, (x, w, b)),
            None if tl is None else jnp.asarray(tl),
            lengths=None if ln is None else jnp.asarray(ln))
        ty, tt = tssm._causal_conv(*map(t, (x, w, b)),
                                   None if tl is None else t(tl),
                                   lengths=None if ln is None else t(ln))
        close(ty, jy, rel=1e-6)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert torch.equal(tt[2], torch.zeros_like(tt[2]))
    _, tt = tssm._causal_conv(*map(t, (x, w, b)), t(tail), lengths=t(lengths))
    assert torch.equal(tt[2], t(tail)[2])


def ssd_inputs(seed, b, s, h, p, n):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(b, s, h)))).astype(np.float32)
    A = -np.exp(rng.normal(size=(h,)) * 0.3).astype(np.float32)
    B = (rng.normal(size=(b, s, n)) * 0.5).astype(np.float32)
    C = (rng.normal(size=(b, s, n)) * 0.5).astype(np.float32)
    return x, dt, A, B, C


@pytest.mark.parametrize("s,chunk,init", [(16, 4, False), (33, 8, True),
                                          (7, 16, True)])
def test_ssd_chunked_and_sequential_match_reference(s, chunk, init):
    """Both SSD forms, with and without an initial state, against the
    reference's, and the port's chunked form against its sequential one
    (the reference's own check, 2e-4)."""
    args = ssd_inputs(s, 2, s, 3, 8, 16)
    h0 = rng_normal(9, (2, 3, 8, 16)) if init else None
    jy, jh = jssm.ssd_chunked(*map(jnp.asarray, args), chunk=chunk,
                              init_state=None if h0 is None
                              else jnp.asarray(h0))
    ty, th = tssm.ssd_chunked(*map(t, args), chunk=chunk,
                              init_state=None if h0 is None else t(h0))
    close(ty, jy)
    close(th, jh)
    jy2, jh2 = jssm.ssd_sequential(*map(jnp.asarray, args),
                                   init_state=None if h0 is None
                                   else jnp.asarray(h0))
    ty2, th2 = tssm.ssd_sequential(*map(t, args),
                                   init_state=None if h0 is None else t(h0))
    close(ty2, jy2)
    close(th2, jh2)
    np.testing.assert_allclose(ty.numpy(), ty2.numpy(), atol=2e-4)
    np.testing.assert_allclose(th.numpy(), th2.numpy(), atol=2e-4)


def recurrent_pair(kind):
    arch = "mamba2-780m" if kind == "ssm" else "recurrentgemma-2b"
    jc, tc = cfg_pair(arch)
    init = jssm.init_ssm if kind == "ssm" else jrg.init_rglru
    p = to_np(init(jc, jax.random.PRNGKey(0)))
    if kind == "rglru":                  # non-zero gate biases
        p["ba"] = rng_normal(1, p["ba"].shape, 0.3)
        p["bx"] = rng_normal(2, p["bx"].shape, 0.3)
    else:
        p["A_log"] = rng_normal(3, p["A_log"].shape, 0.3)
        p["dt_bias"] = rng_normal(4, p["dt_bias"].shape, 0.3)
    jmod, tmod = (jssm, tssm) if kind == "ssm" else (jrg, trg)
    japply = jmod.apply_ssm if kind == "ssm" else jmod.apply_rglru
    tapply = tmod.apply_ssm if kind == "ssm" else tmod.apply_rglru
    return jc, tc, jax.tree.map(jnp.asarray, p), model_params(p, "cpu"), \
        japply, tapply


@pytest.mark.parametrize("kind", ["ssm", "rglru"])
def test_recurrent_mixer_ragged_step_and_decode_match_reference(kind):
    """A ragged padded forward from a carried state, then one decode step,
    against the reference: outputs of the valid positions and the carried
    (conv tail, recurrent) state."""
    jc, tc, jp, tp, japply, tapply = recurrent_pair(kind)
    x0 = rng_normal(5, (3, 6, 64), 0.3)
    _, jst = japply(jp, jnp.asarray(x0), jc, return_state=True)
    _, tst = tapply(tp, t(x0), tc, return_state=True)
    for a, b in zip(tst, jst):
        close(a, b)
    lens = (9, 4, 0)
    x1 = rng_normal(6, (3, 9, 64), 0.3)
    qv = q_valid(lens, 9)
    jy, jst = japply(jp, jnp.asarray(x1), jc, state=jst, return_state=True,
                     q_valid=jnp.asarray(qv))
    ty, tst = tapply(tp, t(x1), tc, state=tst, return_state=True,
                     q_valid=t(qv))
    for b, L in enumerate(lens):
        if L:
            close(ty[b, :L], jy[b, :L])
    for a, b in zip(tst, jst):
        close(a, b)
    x2 = rng_normal(7, (3, 1, 64), 0.3)
    jy, jst = japply(jp, jnp.asarray(x2), jc, state=jst, return_state=True)
    ty, tst = tapply(tp, t(x2), tc, state=tst, return_state=True)
    close(ty, jy)
    for a, b in zip(tst, jst):
        close(a, b)


@pytest.mark.parametrize("kind,sequential", [("ssm", True), ("ssm", False),
                                             ("rglru", False)])
def test_recurrent_padded_stack_equals_trimmed_rows(kind, sequential):
    """The reference's deterministic padded == trimmed cases on the port:
    pad positions are identity steps, so a padded stacked forward equals
    each row run alone, unpadded (valid outputs and carried state).  The
    reference holds its sequential SSD to bitwise equality; the port's
    dense products run through a BLAS whose sums of a 36-row and of a 1-row
    product may round apart (1.2e-7 measured on the in-projection), so both
    SSD paths take the reference's chunked-path bound, 1e-5."""
    jc, tc, jp, tp, japply, tapply = recurrent_pair(kind)
    kw = dict(sequential=sequential) if kind == "ssm" else {}
    S, lens = (12, (12, 7, 1)) if kind == "ssm" else (11, (11, 4, 1))
    x = rng_normal(1, (len(lens), S, 64), 0.2)
    y, st = tapply(tp, t(x), tc, return_state=True, q_valid=t(q_valid(lens,
                                                                      S)),
                   **kw)
    for b, L in enumerate(lens):
        yr, sr = tapply(tp, t(x[b:b + 1, :L]), tc, return_state=True, **kw)
        pairs = [(y[b:b + 1, :L], yr)] + [(a[b:b + 1], r)
                                          for a, r in zip(st, sr)]
        for got, ref in pairs:
            torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("kind", ["ssm", "rglru"])
def test_zero_length_row_carries_state_unchanged(kind):
    jc, tc, jp, tp, japply, tapply = recurrent_pair(kind)
    _, st0 = tapply(tp, t(rng_normal(2, (2, 6, 64), 0.2)), tc,
                    return_state=True)
    _, st1 = tapply(tp, t(rng_normal(3, (2, 5, 64), 0.2)), tc, state=st0,
                    return_state=True, q_valid=t(q_valid((5, 0), 5)))
    for got, ref in zip(st1, st0):
        assert torch.equal(got[1:], ref[1:])
        assert not torch.equal(got[:1], ref[:1])


# ------------------------------------------------------ serving lanes

ZOO = ("h2o-danube-3-4b", "mamba2-780m", "recurrentgemma-2b")


@pytest.fixture(scope="module")
def zoo():
    out = {}
    for arch in ZOO:
        jc, tc = cfg_pair(arch)
        jp, tp = ref_params(jc, seed=5)
        out[arch] = (jbuild(jc), jax.tree.map(jnp.asarray, jp), tbuild(tc),
                     tp)
    return out


def prompt(n, seed):
    return np.random.RandomState(seed).randint(0, 256, size=n).astype(
        np.int32)


def drive(eng, reqs, max_steps=100):
    for r in reqs:
        assert eng.try_add(r)
    for _ in range(max_steps):
        if all(r.done for r in reqs):
            return
        eng.step()
    raise AssertionError(f"not done in {max_steps} steps")


@pytest.mark.parametrize("arch", ZOO)
def test_state_rows_reset_extract_and_merge_exactly(zoo, arch):
    """The lane machinery is generic over the state's named tuples: a row
    extracted from a ragged lane state, merged into a pool and reset holds
    exactly that row's tensors, and leaves every other row untouched."""
    _, _, tm, tp = zoo[arch]
    axes = _batch_axes(tm, 24)
    lanes = tm.init_decode_state(3, 24, device="cpu")
    toks = t(np.random.default_rng(0).integers(0, 256, (3, 5))).long()
    _, lanes = tm.extend(tp, lanes, toks, lengths=t(np.array([5, 3, 0])))
    pool = tm.init_decode_state(4, 24, device="cpu")
    _, pool = tm.extend(tp, pool, toks[:1].expand(4, 5).contiguous())
    before = [a.clone() for a in leaves(pool)]
    _merge_slot(pool, extract_row(lanes, axes, 1), 2)
    flat_axes = _flat(axes)
    for a, b, ax, lane in zip(leaves(pool), before, flat_axes,
                              leaves(lanes)):
        if ax < 0:
            continue
        assert torch.equal(a.narrow(ax, 2, 1), lane.narrow(ax, 1, 1))
        for i in (0, 1, 3):
            assert torch.equal(a.narrow(ax, i, 1), b.narrow(ax, i, 1))
    fresh = tm.init_decode_state(1, 24, device="cpu")
    insert_row(lanes, fresh, axes, 1)
    for a, f, ax in zip(leaves(lanes), leaves(fresh), flat_axes):
        if ax >= 0:
            assert torch.equal(a.narrow(ax, 1, 1), f)
    assert any(isinstance(c, (tssm.SSMState, trg.RGLRUState))
               for c in lanes["caches"]) == (arch != "h2o-danube-3-4b")


def _flat(axes):
    """``_batch_axes``'s ints in ``leaves`` order."""
    if isinstance(axes, int):
        return [axes]
    if isinstance(axes, dict):
        return [a for k in sorted(axes) for a in _flat(axes[k])]
    return [a for v in axes for a in _flat(v)]


@pytest.mark.parametrize("arch", ZOO)
def test_engine_lanes_match_serial_path_and_reference(zoo, arch):
    """Ragged co-batched chunked admission on swa / ssm / rglru stacks
    (``test_serve_prefill.py``): every stream equals the port's solo
    ``generate`` (the serial path) and the reference engine's stream."""
    jm, jp, tm, tp = zoo[arch]
    cfg = dict(n_slots=2, max_len=48, prefill_chunk=4, chunks_per_step=2)
    specs = ((13, 140), (38, 141))
    jreqs = [jserve.Request(uid=i, prompt=prompt(n, s), max_new=3)
             for i, (n, s) in enumerate(specs)]
    treqs = [tserve.Request(uid=i, prompt=prompt(n, s), max_new=3)
             for i, (n, s) in enumerate(specs)]
    drive(jserve.ServeEngine(jm, jp, jserve.ServeConfig(**cfg)), jreqs)
    drive(tserve.ServeEngine(tm, tp, tserve.ServeConfig(**cfg)), treqs)
    for jr, tr in zip(jreqs, treqs):
        solo = tserve.generate(tm, tp, {"tokens": t(tr.prompt[None]).long()},
                               3).tokens[0].tolist()
        assert tr.out == solo == jr.out, tr.uid


class LastLayerFault:
    """Wraps ``transformer.apply_layer``: the first lane forward that
    reaches position ``at`` raises after its last layer ran (every layer
    has written its ring or advanced its state)."""

    def __init__(self, orig, at: int):
        self.orig, self.at, self.armed, self.calls = orig, at, True, 0

    def __call__(self, p, x, cfg, kind, **kw):
        out = self.orig(p, x, cfg, kind, **kw)
        if self.armed and kw.get("mode") == "decode" and x.shape[1] > 1 \
                and int(kw["positions"].max()) >= self.at:
            self.calls += 1
            if self.calls == cfg.n_layers:
                self.armed = False
                raise RuntimeError("fault after the last layer wrote")
        return out


@pytest.mark.parametrize("arch", ZOO)
def test_retried_lane_forward_after_partial_write_is_exact(zoo, arch,
                                                           monkeypatch):
    """A lane forward that raises after every layer ran is retried by the
    engine; sliding-window rings of a chunk are written to a copy and
    recurrent states are rebound only on success, so the streams equal a
    fault-free run's.  The fault hits the chunk that wraps the reduced
    window's ring (32 slots), whose queries need the keys it evicts."""
    _, _, tm, tp = zoo[arch]
    cfg = tserve.ServeConfig(n_slots=2, max_len=48, prefill_chunk=8,
                             chunks_per_step=2)
    specs = ((38, 150), (21, 151))
    clean = [tserve.Request(uid=i, prompt=prompt(n, s), max_new=4)
             for i, (n, s) in enumerate(specs)]
    drive(tserve.ServeEngine(tm, tp, cfg), clean)
    fault = LastLayerFault(ttr.apply_layer, at=32)
    monkeypatch.setattr(ttr, "apply_layer", fault)
    eng = tserve.ServeEngine(tm, tp, cfg)
    reqs = [tserve.Request(uid=i, prompt=prompt(n, s), max_new=4)
            for i, (n, s) in enumerate(specs)]
    for r in reqs:
        assert eng.try_add(r)
    while not all(r.done for r in reqs):
        eng.step()
        tserve.check_invariants(eng)
    assert not fault.armed and len(eng.errors) == 1
    assert [r.out for r in reqs] == [r.out for r in clean]
