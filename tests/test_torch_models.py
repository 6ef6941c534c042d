"""Port parity for the model zoo's transformer path (``repro_torch.models``)
against the JAX reference (``repro.models``), on reduced configs.

Inputs come from numpy seeds; reference parameters cross over through
``repro_torch.convert.model_params``.  The reference's DSLOT MLP runs its
jnp replay (``use_pallas=False``, which the reference's own tests hold equal
to Pallas interpret mode; one case runs Pallas interpret), the port's runs
the kernel's plain version on CPU tensors.

Tolerances: integer results (``planes_used``, positions, tokens) exact; f32
activations and logits within ``1e-4 * max|reference|`` — XLA and PyTorch
sum the same f32 products in different orders, and a DSLOT layer quantizes
its input, so a rounding flip there moves an output by one quantization
step times a weight.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch_one_thread  # noqa: F401  (PyTorch on one CPU thread)

from repro.configs.base import DslotConfig as JDslot
from repro.configs.registry import ARCHS as JARCHS
from repro.models import attention as jatt
from repro.models import layers as jlayers
from repro.models import mlp as jmlp
from repro.models import stats as jstats
from repro.models import transformer as jtr
from repro.models.model_zoo import build_model as jbuild
from repro.serve.engine import _collapse_rows as j_collapse
from repro_torch.configs.base import DslotConfig as TDslot
from repro_torch.configs.registry import ARCHS as TARCHS
from repro_torch.convert import model_params
from repro_torch.models import attention as tatt
from repro_torch.models import layers as tlayers
from repro_torch.models import mlp as tmlp
from repro_torch.models import stats as tstats
from repro_torch.models import transformer as ttr
from repro_torch.models.model_zoo import build_model as tbuild
from repro_torch.serve.engine import _collapse_rows as t_collapse

REL = 1e-4


def cfg_pair(arch, dslot=None, pallas=False, **over):
    """The same reduced config in both packages (``dslot``: DslotConfig
    fields, which the port's config has without ``use_pallas``)."""
    jc = dataclasses.replace(JARCHS[arch].reduced(), **over)
    tc = dataclasses.replace(TARCHS[arch].reduced(), **over)
    if dslot is not None:
        jc = dataclasses.replace(jc, dslot=JDslot(use_pallas=pallas, **dslot))
        tc = dataclasses.replace(tc, dslot=TDslot(**dslot))
    return jc, tc


def to_np(tree):
    return jax.tree.map(np.array, tree)


def t(a, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype)


def close(port, ref, rel=REL):
    port = port.detach().to(torch.float32).numpy()
    ref = np.asarray(ref, np.float32)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    np.testing.assert_allclose(port, ref, rtol=0,
                               atol=rel * max(float(np.abs(ref).max()), 1e-6))


def rng_normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


def ref_params(jc, seed=0):
    """Reference params (jax PRNG) as numpy, and the port's copy."""
    p = to_np(jbuild(jc).init(jax.random.PRNGKey(seed)))
    return p, model_params(p, device="cpu")


def dead_columns(params):
    """Make half of every MLP up-projection's columns ReLU-dead: a positive
    ``norm2`` bias lifts every normalized input by 1, so subtracting 0.5
    from a column's weights sends its output far below zero and whole
    output tiles terminate early."""
    def walk(node):
        if isinstance(node, dict):
            node = {k: walk(v) for k, v in node.items()}
            if "mlp" in node and "norm2" in node:
                node["norm2"] = {**node["norm2"],
                                 "bias": np.ones_like(node["norm2"]["bias"])}
                w = node["mlp"]["up"]["w"].copy()
                w[..., ::2] -= 0.5
                node["mlp"] = {**node["mlp"], "up": {"w": w}}
            return node
        if isinstance(node, list):
            return [walk(v) for v in node]
        return node
    return walk(params)


# ----------------------------------------------------------------- layers

@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm", "nonparam_ln"])
def test_norms_match_reference(norm):
    jc, tc = cfg_pair("olmo-1b", norm=norm)
    x = rng_normal(0, (2, 5, 64)) * 3 + 1
    p = {}
    if norm != "nonparam_ln":
        p["scale"] = rng_normal(1, (64,)) + 1
    if norm == "layernorm":
        p["bias"] = rng_normal(2, (64,))
    ref = jlayers.apply_norm(jax.tree.map(jnp.asarray, p), jnp.asarray(x), jc)
    out = tlayers.apply_norm({k: t(v) for k, v in p.items()}, t(x), tc)
    close(out, ref, rel=1e-6)


@pytest.mark.parametrize("per_row", [False, True])
def test_rope_matches_reference(per_row):
    x = rng_normal(3, (2, 6, 4, 16))
    pos = np.arange(6, dtype=np.int32) + 3
    if per_row:
        pos = np.stack([pos, pos * 7 + 100]).astype(np.int32)
    ref = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)
    close(tlayers.apply_rope(t(x), t(pos), 10_000.0), ref, rel=1e-6)


@pytest.mark.parametrize("tied", [False, True])
def test_logits_match_reference(tied):
    jc, tc = cfg_pair("olmo-1b", tie_embeddings=tied)
    emb = {"embedding": rng_normal(4, (256, 64), 0.1)}
    head = {} if tied else {"w": rng_normal(5, (64, 256), 0.1)}
    x = rng_normal(6, (2, 3, 64))
    ref = jlayers.lm_logits(jax.tree.map(jnp.asarray, head),
                            jax.tree.map(jnp.asarray, emb), jnp.asarray(x),
                            jc)
    out = tlayers.lm_logits({k: t(v) for k, v in head.items()},
                            {k: t(v) for k, v in emb.items()}, t(x), tc)
    close(out, ref)


def test_dense_with_bias_and_embedding_match_reference():
    p = {"w": rng_normal(7, (64, 48), 0.1), "b": rng_normal(8, (48,))}
    x = rng_normal(9, (3, 64))
    ref = jlayers.apply_dense(jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    close(tlayers.apply_dense({k: t(v) for k, v in p.items()}, t(x)), ref)
    tok = np.random.default_rng(10).integers(0, 256, (2, 5)).astype(np.int32)
    emb = rng_normal(11, (256, 64))
    jc, tc = cfg_pair("olmo-1b")
    np.testing.assert_array_equal(
        tlayers.embed_tokens({"embedding": t(emb)}, t(tok).long(),
                             tc).numpy(),
        np.asarray(jlayers.embed_tokens({"embedding": jnp.asarray(emb)},
                                        jnp.asarray(tok), jc)))


@pytest.mark.parametrize("act", ["silu", "gelu", "relu"])
def test_activations_bf16_match_reference_exactly(act):
    """The activations round to the value dtype op by op, as the reference's
    trace does (``F.silu`` and ``F.gelu`` round once and differ in bf16)."""
    x = jnp.asarray(rng_normal(12, (50_000,), 3.0), jnp.bfloat16)
    ref = jax.jit(jmlp._ACTS[act])(x)
    out = tmlp._ACTS[act](t(x.astype(jnp.float32)).to(torch.bfloat16))
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(out.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))


# ----------------------------------------------------------------- attention

def attn_params(jc, seed, cross=False):
    p = to_np(jatt.init_attention(jc, jax.random.PRNGKey(seed), cross=cross))
    for i, name in enumerate(sorted(p)):     # non-zero biases, if any
        if "b" in p[name]:
            p[name]["b"] = rng_normal(seed + i, p[name]["b"].shape, 0.1)
    return p, model_params(p, device="cpu")


def run_attention(jp, tp, jc, tc, x, pos, **kw):
    """Both packages' ``attention_forward`` on the same inputs; numpy
    arrays in ``kw`` go to both (KVCache tuples included)."""
    def conv(v, f):
        if isinstance(v, tuple):
            return tuple(conv(a, f) for a in v)
        return f(v) if isinstance(v, np.ndarray) else v
    jkw = {k: conv(v, jnp.asarray) for k, v in kw.items()}
    tkw = {k: conv(v, t) for k, v in kw.items()}
    if "cache" in kw:
        jkw["cache"] = jatt.KVCache(*jkw["cache"])
        tkw["cache"] = tatt.KVCache(*tkw["cache"])
    jy, jcache = jatt.attention_forward(jp, jnp.asarray(x), jc,
                                        positions=jnp.asarray(pos), **jkw)
    ty, tcache = tatt.attention_forward(tp, t(x), tc, positions=t(pos),
                                        **tkw)
    close(ty, jy)
    return jcache, tcache


def same_cache(jcache, tcache):
    np.testing.assert_array_equal(tcache.positions.numpy(),
                                  np.asarray(jcache.positions))
    close(tcache.k, jcache.k)
    close(tcache.v, jcache.v)


@pytest.mark.parametrize("arch,S,causal", [
    ("olmo-1b", 12, True),        # one flash pass, two KV chunks
    ("qwen2.5-3b", 40, True),     # GQA, qkv bias, query chunks (S > 32)
    ("olmo-1b", 20, False)])      # encoder-style, no mask
def test_self_attention_and_prefill_ring_match_reference(arch, S, causal):
    jc, tc = cfg_pair(arch)
    jp, tp = attn_params(jc, 1)
    x = rng_normal(2, (2, S, 64))
    pos = np.arange(S, dtype=np.int32)
    jcache, tcache = run_attention(jp, tp, jc, tc, x, pos, causal=causal,
                                   return_cache=True, cache_len=S + 6)
    same_cache(jcache, tcache)


def test_ragged_prefill_ring_matches_reference():
    """Right-padded rows build their rings from their own valid positions
    (the per-(row, slot) owner gather), including a ring smaller than a
    row."""
    jc, tc = cfg_pair("olmo-1b")
    jp, tp = attn_params(jc, 3)
    x = rng_normal(4, (3, 10, 64))
    pos = np.arange(10, dtype=np.int32)
    q_valid = np.arange(10)[None] < np.array([[10], [4], [0]])
    jcache, tcache = run_attention(jp, tp, jc, tc, x, pos, q_valid=q_valid,
                                   return_cache=True, cache_len=6)
    same_cache(jcache, tcache)


def test_cross_attention_prefill_and_decode_match_reference():
    jc, tc = cfg_pair("seamless-m4t-medium")
    jp, tp = attn_params(jc, 5, cross=True)
    x = rng_normal(6, (2, 7, 64))
    enc = rng_normal(7, (2, 8, 64))
    jcache, tcache = run_attention(jp, tp, jc, tc, x,
                                   np.arange(7, dtype=np.int32),
                                   kv_x=enc, causal=False, return_cache=True)
    same_cache(jcache, tcache)
    cache = tuple(np.asarray(a) for a in jcache)
    run_attention(jp, tp, jc, tc, rng_normal(8, (2, 1, 64)),
                  np.array([[7], [7]], np.int32), cache=cache,
                  is_cross=True, causal=False)


@pytest.mark.parametrize("S", [1, 3])
def test_decode_ring_writes_at_per_row_offsets_match_reference(S):
    """Rows at different depths write their own ring slots (wrapping the
    ring for one row); ``q_valid`` pad rows write back what the ring holds
    and attend against per-row positions."""
    jc, tc = cfg_pair("qwen2.5-3b")
    jp, tp = attn_params(jc, 9)
    C = 8
    rng = np.random.default_rng(10)
    k = rng.normal(size=(3, C, 2, 16)).astype(np.float32)
    v = rng.normal(size=(3, C, 2, 16)).astype(np.float32)
    depth = np.array([3, 7, 0])
    positions = np.full((3, C), -1, np.int32)
    for b, d in enumerate(depth):
        positions[b, :d] = np.arange(d)
    pos = (depth[:, None] + np.arange(S)[None]).astype(np.int32)
    q_valid = np.arange(S)[None] < np.array([[S], [max(S - 1, 1)], [0]])
    jcache, tcache = run_attention(
        jp, tp, jc, tc, rng_normal(11, (3, S, 64)), pos,
        cache=(k, v, positions), q_valid=q_valid)
    same_cache(jcache, tcache)


def test_cache_extension_wider_than_ring_raises():
    _, tc = cfg_pair("olmo-1b")
    tp = attn_params(cfg_pair("olmo-1b")[0], 1)[1]
    cache = tatt.init_kv_cache(tc, 1, 4, torch.float32, "cpu")
    with pytest.raises(ValueError, match="ring"):
        tatt.attention_forward(tp, torch.zeros((1, 5, 64)), tc,
                               positions=torch.arange(5, dtype=torch.int32),
                               cache=cache)


# ----------------------------------------------------------------- mlp

@pytest.mark.parametrize("arch", ["olmo-1b", "seamless-m4t-medium"])
def test_dense_mlp_matches_reference(arch):
    """SwiGLU (olmo) and ReLU without a GLU (seamless)."""
    jc, tc = cfg_pair(arch)
    p = to_np(jmlp.init_mlp(jc, jax.random.PRNGKey(2)))
    x = rng_normal(3, (2, 5, 64))
    ref = jmlp.apply_mlp(jax.tree.map(jnp.asarray, p), jnp.asarray(x), jc)
    close(tmlp.apply_mlp(model_params(p, device="cpu"), t(x), tc), ref)


@pytest.mark.parametrize("prepared,pallas", [(True, False), (False, False),
                                             (True, True)])
def test_dslot_mlp_matches_reference(prepared, pallas):
    dslot = dict(enabled=True, block_m=16, block_n=32, block_k=32)
    jc, tc = cfg_pair("seamless-m4t-medium", dslot=dslot, pallas=pallas)
    p = to_np(jmlp.init_mlp(jc, jax.random.PRNGKey(4)))
    p["up"]["w"][:, ::2] -= 0.2              # ReLU-dead columns
    x = np.abs(rng_normal(5, (2, 9, 64)))
    jp, tp = jax.tree.map(jnp.asarray, p), model_params(p, device="cpu")
    if prepared:
        jp, tp = jmlp.prepare_mlp_dslot(jp, jc), tmlp.prepare_mlp_dslot(tp, tc)
        tw, jw = tp["up"]["dslot"], jp["up"]["dslot"]
        # integer tables exact; |W| column sums within f32 summation order
        for name in ("msr_bound", "inv_perm"):
            np.testing.assert_array_equal(getattr(tw, name).numpy(),
                                          np.asarray(getattr(jw, name)))
        for name in ("suffix_colsum", "total_colsum"):
            np.testing.assert_allclose(getattr(tw, name).numpy(),
                                       np.asarray(getattr(jw, name)),
                                       rtol=1e-6)
    with jstats.collect() as js:
        ref = jmlp.apply_mlp(jp, jnp.asarray(x), jc)
    with tstats.collect() as ts:
        out = tmlp.apply_mlp(tp, t(x), tc)
    close(out, ref)
    assert sorted(ts) == sorted(js)
    for name in js:
        for a, b in zip(ts[name], js[name]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-7)
    used = float(ts["mlp_dslot_planes_used"][0])
    assert 0 < used < 8, "termination must fire on the dead columns"
    # the layer's per-tile planes, exactly
    _, jst = jmlp._dslot_up_layer(jc).apply(jp["up"], jnp.asarray(x))
    _, tst = tmlp._dslot_up_layer(tc).apply(tp["up"], t(x))
    np.testing.assert_array_equal(tst.planes_used.numpy(),
                                  np.asarray(jst.planes_used))


def test_prepare_stacked_mlp_gives_one_state_per_layer():
    jc, tc = cfg_pair("seamless-m4t-medium",
                      dslot=dict(enabled=True, block_m=16, block_n=32))
    p = to_np(jmlp.init_mlp(jc, jax.random.PRNGKey(6)))
    stacked = {k: {"w": np.stack([v["w"], -v["w"], 2 * v["w"]])}
               for k, v in p.items()}
    jp = jmlp.prepare_mlp_dslot(jax.tree.map(jnp.asarray, stacked), jc)
    tp = tmlp.prepare_mlp_dslot(model_params(stacked, device="cpu"), tc)
    assert len(tp["up"]["dslot"]) == 3
    for g, dw in enumerate(tp["up"]["dslot"]):
        np.testing.assert_allclose(
            dw.suffix_colsum.numpy(),
            np.asarray(jp["up"]["dslot"].suffix_colsum[g]), rtol=1e-6)
        np.testing.assert_array_equal(
            dw.inv_perm.numpy(), np.asarray(jp["up"]["dslot"].inv_perm[g]))
    # not a digit-serial config: unchanged
    _, olmo = cfg_pair("olmo-1b")
    assert tmlp.prepare_mlp_dslot({"mlp": 1}, olmo) == {"mlp": 1}


# ----------------------------------------------------------------- stack

def test_stack_with_groups_and_rest_matches_reference():
    """5 layers of period 2: two groups and one rest layer.  Outputs agree
    and the DSLOT statistics come out with the reference's group axis, so
    the per-row average weighs groups and rest alike in both."""
    dslot = dict(enabled=True, block_m=16, block_n=32)
    jc, tc = cfg_pair("seamless-m4t-medium", dslot=dslot, scan_unroll=2)
    js_, ts_ = jtr.Stack(jc, ("attn",), 5), ttr.Stack(tc, ("attn",), 5)
    assert (ts_.n_groups, ts_.n_rest) == (js_.n_groups, js_.n_rest) == (2, 1)
    p = dead_columns(to_np(js_.init(jax.random.PRNGKey(7))))
    jp = jmlp.prepare_mlp_dslot(jax.tree.map(jnp.asarray, p), jc)
    tp = tmlp.prepare_mlp_dslot(model_params(p, device="cpu"), tc)
    x = rng_normal(8, (2, 6, 64))
    pos = np.arange(6, dtype=np.int32)
    with jstats.collect() as jsink:
        jy, _, _ = js_.apply(jp, jnp.asarray(x), positions=jnp.asarray(pos))
    with tstats.collect() as tsink:
        ty, _, _ = ts_.apply(tp, t(x), positions=t(pos))
    close(ty, jy)
    for name in jsink:
        assert [tuple(v.shape) for v in tsink[name]] == \
            [np.shape(v) for v in jsink[name]], name
    close(t_collapse(tsink, 12), j_collapse(jsink, 12), rel=1e-6)


# ----------------------------------------------------------------- model

def model_batch(tc, B, S, seed):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, tc.vocab_size, (B, S)).astype(np.int32)}
    if tc.frontend:
        batch["frontend"] = rng_normal(seed + 1, (B, tc.frontend_len, 64), 0.5)
    if tc.family == "encdec":
        batch["src_embeds"] = rng_normal(seed + 2, (B, 8, 64), 0.5)
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: t(v) if v.dtype != np.int32 else t(v).long()
             for k, v in batch.items()})


def leaves(tree):
    """A port tree's tensors in ``jax.tree.leaves`` order (dict keys
    sorted, lists, tuples and KVCache fields in order)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [a for k in sorted(tree) for a in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [a for v in tree for a in leaves(v)]
    return []


def ref_caches(stack, caches):
    """The port's per-layer caches in the reference's layout: each pattern
    position's layers stacked over the groups, then the rest layers."""
    def stacked(trees):
        if isinstance(trees[0], torch.Tensor):
            return torch.stack(trees)
        vals = [stacked(list(v)) for v in zip(*trees)]
        return type(trees[0])(*vals) if hasattr(trees[0], "_fields") \
            else tuple(vals)
    G, P = stack.n_groups, stack.period
    return {"groups": [stacked(caches[pos:G * P:P])
                       for pos in range(P if G else 0)],
            "rest": caches[G * P:]}


def same_state(jstate, tstate, stack):
    np.testing.assert_array_equal(tstate["pos"].numpy(),
                                  np.asarray(jstate["pos"]))
    jl = jax.tree.leaves(jstate["caches"])
    tl = leaves(ref_caches(stack, tstate["caches"]))
    assert [tuple(a.shape) for a in tl] == [b.shape for b in jl]
    for a, b in zip(tl, jl):
        if a.dtype == torch.int32:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        else:
            close(a, b)


@pytest.mark.parametrize("arch", ["seamless-m4t-medium", "olmo-1b",
                                  "qwen2.5-3b", "internvl2-26b",
                                  "h2o-danube-3-4b", "granite-moe-1b-a400m",
                                  "mamba2-780m", "recurrentgemma-2b",
                                  "mixtral-8x22b", "deepseek-67b"])
def test_model_forward_prefill_decode_extend_match_reference(arch):
    jc, tc = cfg_pair(arch)
    jm, tm = jbuild(jc), tbuild(tc)
    jp, tp = ref_params(jc, seed=1)
    jp = jax.tree.map(jnp.asarray, jp)
    jb, tb = model_batch(tc, 2, 6, seed=2)
    ref, jaux, _ = jm.forward(jp, jb)
    out, aux, caches = tm.forward(tp, tb)
    assert caches is None
    close(out, ref)
    close(aux, jaux)

    lengths = np.array([6, 3], np.int32)
    jl, jst = jm.prefill(jp, jb, max_len=24, lengths=jnp.asarray(lengths))
    tl, tst = tm.prefill(tp, tb, max_len=24, lengths=t(lengths))
    close(tl, jl)
    same_state(jst, tst, tm.decoder)

    tok = np.array([[5], [9]], np.int32)
    jl, jst = jm.decode_step(jp, jst, jnp.asarray(tok))
    tl, tst = tm.decode_step(tp, tst, t(tok).long())
    close(tl, jl)
    same_state(jst, tst, tm.decoder)

    chunk = np.random.default_rng(3).integers(0, 256, (2, 4)).astype(np.int32)
    ext = np.array([4, 2], np.int32)
    jl, jst = jm.extend(jp, jst, jnp.asarray(chunk), lengths=jnp.asarray(ext))
    tl, tst = tm.extend(tp, tst, t(chunk).long(), lengths=t(ext))
    close(tl, jl)
    same_state(jst, tst, tm.decoder)
    jl, jst = jm.extend(jp, jst, jnp.asarray(chunk))
    tl, tst = tm.extend(tp, tst, t(chunk).long())
    close(tl, jl)
    same_state(jst, tst, tm.decoder)


def test_decode_state_with_groups_and_rest_matches_reference():
    """Five decoder layers of period 2 (two groups and a rest layer): the
    port's per-layer caches are the reference's stacked ones, layer
    ``g * period + pos`` at group ``g``, position ``pos``."""
    jc, tc = cfg_pair("seamless-m4t-medium", scan_unroll=2, n_layers=5)
    jm, tm = jbuild(jc), tbuild(tc)
    assert (tm.decoder.n_groups, tm.decoder.n_rest) == (2, 1)
    jp, tp = ref_params(jc, seed=4)
    jp = jax.tree.map(jnp.asarray, jp)
    jb, tb = model_batch(tc, 2, 5, seed=5)
    jl, jst = jm.prefill(jp, jb, max_len=12)
    tl, tst = tm.prefill(tp, tb, max_len=12)
    close(tl, jl)
    same_state(jst, tst, tm.decoder)
    tok = np.array([[7], [1]], np.int32)
    jl, jst = jm.decode_step(jp, jst, jnp.asarray(tok))
    tl, tst2 = tm.decode_step(tp, tst, t(tok).long())
    close(tl, jl)
    same_state(jst, tst2, tm.decoder)
    assert all(a is b for a, b in zip(leaves(tst2["caches"]),
                                      leaves(tst["caches"]))), \
        "decode writes the caches in place"


# bf16 parity runs the reference op by op (``jax.disable_jit``).  Compiled,
# XLA may fuse a bf16 op into its f32 consumer and skip the rounding in
# between (``xla_allow_excess_precision``, on by default), so the compiled
# reference's bf16 values depend on its fusion; op by op, every op rounds to
# the value dtype, as the port's do.  What is left is the order of the f32
# sums inside products, which now and then flips an output's last bf16 bit;
# a flip spreads through the later layers (a DSLOT layer's quantizer turns
# it into a whole quantization step).  Measured on these seeds: port vs
# reference 0 to 1.6e-3 mean relative difference on the logits; the same
# model in f32, or the port with any one bf16 rounding step left out
# (probabilities, normalization, dense output, DSLOT MLP output), 7e-3 and
# more.  Each test also checks that the f32 model fails the tolerance.
BF16_MEAN = 3e-3     # mean |port - ref| / mean |ref|
BF16_MAX = 2 ** -5   # max |port - ref| / max |ref|: 4 to 8 bf16 ulps


def bf16_deviation(port, ref) -> tuple[float, float]:
    port = port.detach().to(torch.float32).numpy()
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    assert port.shape == ref.shape, (port.shape, ref.shape)
    d = np.abs(port - ref)
    return (float(d.mean() / np.abs(ref).mean()),
            float(d.max() / np.abs(ref).max()))


def bf16_close(port, ref, port_f32):
    """bf16 logits within the tolerance of the reference's, and the same
    model computed in f32 outside it."""
    assert port.dtype == torch.bfloat16
    mean, mx = bf16_deviation(port, ref)
    assert mean <= BF16_MEAN and mx <= BF16_MAX, (mean, mx)
    assert bf16_deviation(port_f32, ref)[0] > BF16_MEAN


def to_f32(tree):
    """A port tree with every floating tensor in f32."""
    if isinstance(tree, torch.Tensor):
        return tree.float() if tree.is_floating_point() else tree
    if isinstance(tree, dict):
        return {k: to_f32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_f32(v) for v in tree]
    return tree


@pytest.mark.parametrize("arch,dslot", [("seamless-m4t-medium", True),
                                        ("seamless-m4t-medium", False),
                                        ("olmo-1b", False),
                                        ("qwen2.5-3b", False),
                                        ("h2o-danube-3-4b", False),
                                        ("granite-moe-1b-a400m", False),
                                        ("mamba2-780m", False),
                                        ("recurrentgemma-2b", False)])
def test_model_bf16_matches_eager_reference(arch, dslot):
    """forward / prefill / decode_step / extend in bf16, the reference run
    op by op; with DSLOT the MLP up-projections run digit-serially (half of
    their columns ReLU-dead, so termination fires)."""
    kw = dict(dslot=dict(enabled=True, block_m=4, block_n=32)) if dslot \
        else {}
    jc, tc = cfg_pair(arch, dtype="bfloat16", **kw)
    tc32 = dataclasses.replace(tc, dtype="float32")
    jm, tm, tm32 = jbuild(jc), tbuild(tc), tbuild(tc32)
    p, _ = ref_params(jc, seed=1)
    if dslot:
        p = dead_columns(p)
    tp = tm.prepare_dslot(model_params(p, device="cpu"))
    tp32 = tm32.prepare_dslot(to_f32(model_params(p, device="cpu")))
    jb, tb = model_batch(tc, 4, 6, seed=2)
    lengths = np.array([6, 3, 5, 6], np.int32)
    tok = np.array([[5], [9], [3], [4]], np.int32)
    chunk = np.random.default_rng(3).integers(0, 256, (4, 3)).astype(np.int32)
    ext = np.array([3, 2, 0, 3], np.int32)
    with jax.disable_jit():
        jp = jm.prepare_dslot(jax.tree.map(jnp.asarray, p))
        ref, _, _ = jm.forward(jp, jb)
        bf16_close(tm.forward(tp, tb)[0], ref, tm32.forward(tp32, tb)[0])
        jl, jst = jm.prefill(jp, jb, max_len=16,
                             lengths=jnp.asarray(lengths))
        tl, tst = tm.prefill(tp, tb, max_len=16, lengths=t(lengths))
        tl32, tst32 = tm32.prefill(tp32, tb, max_len=16, lengths=t(lengths))
        bf16_close(tl, jl, tl32)
        jl, jst = jm.decode_step(jp, jst, jnp.asarray(tok))
        tl, tst = tm.decode_step(tp, tst, t(tok).long())
        tl32, tst32 = tm32.decode_step(tp32, tst32, t(tok).long())
        bf16_close(tl, jl, tl32)
        jl, jst = jm.extend(jp, jst, jnp.asarray(chunk),
                            lengths=jnp.asarray(ext))
        tl, tst = tm.extend(tp, tst, t(chunk).long(), lengths=t(ext))
        tl32, _ = tm32.extend(tp32, tst32, t(chunk).long(), lengths=t(ext))
        bf16_close(tl, jl, tl32)
    np.testing.assert_array_equal(tst["pos"].numpy(), np.asarray(jst["pos"]))
    for a, b in zip(leaves(ref_caches(tm.decoder, tst["caches"])),
                    jax.tree.leaves(jst["caches"])):
        assert a.dtype == {"int32": torch.int32, "float32": torch.float32,
                           "bfloat16": torch.bfloat16}[b.dtype.name]
        if a.dtype == torch.int32:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_model_products_accumulate_in_f32(monkeypatch):
    """Every product of forward, prefill, decode_step and extend runs with
    TF32 and cuBLAS's half-precision split-K reduction off (PyTorch allows
    the latter for bf16 by default; the reference accumulates in f32), and
    the caller's flags come back afterwards."""
    mm = torch.backends.cuda.matmul
    flags = ("allow_tf32", "allow_bf16_reduced_precision_reduction",
             "allow_fp16_reduced_precision_reduction")
    for f in flags:
        monkeypatch.setattr(mm, f, True)
    seen = []
    for name in ("matmul", "einsum"):
        monkeypatch.setattr(torch, name, lambda *a, _fn=getattr(torch, name):
                            seen.append(tuple(getattr(mm, f) for f in flags))
                            or _fn(*a))
    _, tc = cfg_pair("seamless-m4t-medium", dtype="bfloat16")
    tm = tbuild(tc)
    tp = tm.init(torch.Generator().manual_seed(0), device="cpu")
    _, tb = model_batch(tc, 2, 4, seed=6)
    tm.forward(tp, tb)
    _, st = tm.prefill(tp, tb, max_len=8)
    _, st = tm.decode_step(tp, st, torch.zeros((2, 1), dtype=torch.long))
    tm.extend(tp, st, torch.zeros((2, 2), dtype=torch.long))
    assert len(seen) > 50 and set(seen) == {(False, False, False)}
    assert all(getattr(mm, f) for f in flags)


def test_init_decode_state_and_param_count_match_reference():
    jc, tc = cfg_pair("seamless-m4t-medium")
    jm, tm = jbuild(jc), tbuild(tc)
    jp, tp = ref_params(jc)
    own = tm.init(torch.Generator().manual_seed(0), device="cpu")
    assert [(tuple(a.shape), a.dtype) for a in leaves(own)] == \
        [(tuple(a.shape), a.dtype) for a in leaves(tp)]
    assert [tuple(a.shape) for a in leaves(tp)] == \
        [b.shape for b in jax.tree.leaves(jp)]
    assert tm.param_count(own) == tm.param_count(tp) == jm.param_count(jp)
    jst = jm.init_decode_state(2, 16, enc_len=8)
    tst = tm.init_decode_state(2, 16, enc_len=8, device="cpu")
    same_state(jst, tst, tm.decoder)


def test_default_device_is_cuda_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tc = cfg_pair("seamless-m4t-medium")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tbuild(tc).init(torch.Generator().manual_seed(0))


def test_model_params_drops_prepared_state():
    """A prepared reference tree converts to the same tree as the bare one:
    the reference's ``"dslot"`` entries are dropped, layers keep their
    places."""
    jc, tc = cfg_pair("seamless-m4t-medium", dslot=dict(enabled=True),
                      scan_unroll=1, n_layers=4)
    jm = jbuild(jc)
    p = jm.init(jax.random.PRNGKey(2))
    prepared = model_params(jm.prepare_dslot(p), device="cpu")
    bare = model_params(to_np(p), device="cpu")
    assert "dslot" in jm.prepare_dslot(p)["decoder"]["groups"][0]["mlp"]["up"]
    assert "dslot" not in prepared["decoder"]["groups"][0]["mlp"]["up"]
    assert len(leaves(prepared)) == len(leaves(bare))
    for a, b in zip(leaves(prepared), leaves(bare)):
        assert torch.equal(a, b)
