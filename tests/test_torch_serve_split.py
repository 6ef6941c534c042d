"""Port parity: serving split over the model axis (``pspec.model_shard`` with
``train.sharding.model_slice``), on ``gloo`` worlds of 2 and 4 ranks over a
(1, n) mesh on the CPU, one world per size.

Each rank serves on its model slice of the parameters: attention by heads
(the "kv", "group" and "repeat" schemes, and heads that do not divide,
which stay whole) over KV rings split along their slots, where the ranks'
partial softmax states are combined; the MLP and the experts by ``d_ff``;
embedding and head by the vocab; the Mamba2 mixer by SSD head and the
RG-LRU by width, each with its recurrent state.  Held here, on reduced
configs (rank bodies in ``torch_serve_split_ranks``, which imports no
JAX):

* the combine against ``flash_attention`` over the whole ring (empty
  slots, rows that see no key on a rank, a sliding window);
* ``prefill`` -> ``decode_step`` -> ``extend`` logits against the unsplit
  port for each scheme, SWA (a carry-window extension), MoE, an enc-dec
  cross cache, a ring whose capacity the ranks do not divide, bf16,
  mamba2 (8 SSD heads; and 2 heads, which stay whole on 4 ranks) and the
  recurrentgemma hybrid (a 64-wide RG-LRU beside "group" attention), the
  mixers' per-channel leaves drawn from a seed so that a rank reading
  another's heads shows; and against the reference's unsplit model for
  ``REF_CASES``.  The
  sequence is ``test_torch_models.py``'s serving case (its seeds, lengths
  and chunks), which holds the unsplit port to the reference on every
  architecture, bf16 included;
* each rank's rings: a ``KVShard`` of C/n slots where n divides C, the
  whole ring otherwise; the blocks in rank order are the unsplit ring;
* each rank's recurrent states: its H/n SSD heads and their x conv
  channels beside the whole B/C tail, or W/n of the RG-LRU's ``h`` and
  conv tail, where n divides; the blocks in rank order are the unsplit
  state;
* ``ServeEngine(mesh=...)``'s greedy streams and ``planes_used_mean``
  against the unsplit port engine's and the reference engine's, and its
  refusal of a split axis other than "model"; the hybrid's split engine
  (ReLU DSLOT MLPs, its RG-LRU and rings split) against the unsplit port
  engine's.

Tolerances: the split sums the same f32 products in another order (the
row-parallel "g", the softmax combine), so f32 logits and attention agree
within ``REL`` of the largest |value|; against the reference within
``REF_REL``, ``test_torch_models.py``'s bound; bf16 logits within
``BF16_REL`` (a few bf16 roundings of such sums: the combine rescales
probabilities rounded against each rank's own max).  Ring positions, token
streams and plane accounts are exact.  A rank's recurrent state comes out
of the same reordered sums in earlier layers, so its blocks rebuild the
unsplit state within ``REL``; their shapes are exact.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch_one_thread  # noqa: F401  (PyTorch on one CPU thread)

import torch_serve_split_ranks as ranks
from repro import serve as jserve
from repro.models.model_zoo import build_model as jbuild
from repro_torch.launch.mesh import run_world
from repro_torch.models.attention import (KVShard, attention_forward,
                                          flash_attention, init_attention)
from repro_torch.models.model_zoo import build_model

from test_torch_models import cfg_pair, model_batch, ref_params

REL = 1e-5
REF_REL = 1e-4
BF16_REL = 2.0 ** -6

# name -> (arch, config overrides, max_len); the sequence is
# test_torch_models.py's serving case (its seeds, lengths and chunks)
CASES = {
    "kv": ("olmo-1b", {}, 24),                  # "kv" on 2, "repeat" on 4
    "group": ("qwen2.5-3b", dict(n_kv_heads=1), 24),
    # "group" with uneven kv reads on 2; 6 heads stay whole on 4
    "group-uneven": ("qwen2.5-3b", dict(n_heads=6, n_kv_heads=3), 24),
    "swa": ("h2o-danube-3-4b", dict(window=8), 24),   # 8 slots, carry
    "moe": ("granite-moe-1b-a400m", {}, 24),
    "cross": ("seamless-m4t-medium", {}, 24),   # cross ring of 8 slots
    "whole-ring": ("olmo-1b", {}, 23),          # 23 slots stay whole
    "bf16": ("olmo-1b", dict(dtype="bfloat16"), 24),
    "ssm": ("mamba2-780m", {}, 24),             # 8 SSD heads
    "ssm-h2": ("mamba2-780m", dict(ssm_headdim=64), 24),  # whole on 4
    "hybrid": ("recurrentgemma-2b", {}, 24),    # RG-LRU 64 wide
}
F32_CASES = [c for c in CASES if c != "bf16"]
RECURRENT_CASES = ["ssm", "ssm-h2", "hybrid"]
REF_CASES = ["kv", "swa", "cross", "ssm"]   # a JAX compile each
MIXER_VECTORS = ("conv_b", "A_log", "D_skip", "dt_bias", "norm_scale",
                 "ba", "bx", "lam")
DSLOT = dict(enabled=True, block_m=16, block_n=32, block_k=16,
             act_scale=0.05)
# (prompt, max_new, planes): five requests through 2 slots, 2 lanes
TRAFFIC = (([3, 1, 4, 1, 5, 9, 2, 6, 5], 6, 8), ([2, 7, 1], 5, 5),
           ([1, 6, 1, 8, 0, 3, 3], 4, None), ([9, 9, 8, 2, 4], 6, 6),
           ([5, 3, 5, 8], 5, 3))


def combine_cases() -> list:
    """Attention against an 8-slot ring: decode rows with empty slots and
    keys on one block only, a 3-query chunk walked 2 keys at a time, and a
    sliding window whose keys lie on the second half of the ring."""
    rng = np.random.default_rng(5)

    def qkv(Sq):
        return dict(q=rng.normal(size=(2, Sq, 4, 8)).astype(np.float32),
                    k=rng.normal(size=(2, 8, 2, 8)).astype(np.float32),
                    v=rng.normal(size=(2, 8, 2, 8)).astype(np.float32))
    ring = np.array([[8, 9, 10, 11, 4, 5, 6, 7],
                     [0, 1, 2, 3, -1, -1, -1, -1]], np.int32)
    return [
        dict(qkv(1), q_pos=np.array([[11], [3]], np.int32), k_pos=ring,
             causal=True, window=0, chunk=16),
        dict(qkv(3), q_pos=np.array([5, 6, 7], np.int32),
             k_pos=np.array([0, 1, 2, 3, 4, 5, 6, -1], np.int32),
             causal=True, window=0, chunk=2),
        dict(qkv(1), q_pos=np.array([[15], [9]], np.int32),
             k_pos=np.array([[8, 9, 10, 11, 12, 13, 14, 15],
                             [8, 9, 2, 3, 4, 5, 6, 7]], np.int32),
             causal=True, window=4, chunk=16),
    ]


class Cases:
    """Each case's config pair, reference parameters, batch, and the
    unsplit port's and the reference's logits."""

    def __init__(self):
        self.models, self.port, self.ref = {}, {}, {}
        for name, (arch, over, max_len) in CASES.items():
            jc, tc = cfg_pair(arch, **over)
            p_np = varied(ref_params(jc, seed=1)[0])
            jb, tb = model_batch(tc, 2, 6, seed=2)
            batch = {k: np.asarray(v) for k, v in jb.items()}
            self.models[name] = dict(cfg=tc, params=p_np, batch=batch,
                                     max_len=max_len)
            logits, state = ranks.serve_sequence(
                build_model(tc), ranks.model_params(p_np, device="cpu"),
                {k: ranks.t(v) for k, v in batch.items()}, max_len)
            self.port[name] = (logits, ranks.rings(state),
                               ranks.recurrent(state))
            if name in REF_CASES:
                self.ref[name] = reference_sequence(jc, p_np, jb, max_len)
        self.jc, self.tc = cfg_pair("olmo-1b", dslot=DSLOT, act="relu",
                                    glu=False)
        self.engine_params, _ = ref_params(self.jc, seed=0)
        jh, self.hybrid_cfg = cfg_pair("recurrentgemma-2b", dslot=DSLOT,
                                       act="relu", glu=False)
        self.hybrid_params = varied(ref_params(jh, seed=0)[0])


def varied(p_np):
    """``p_np`` with the recurrent mixers' per-channel leaves drawn from a
    seed (the reference's init sets them to constants, which a rank
    reading another rank's heads or channels would not change)."""
    rng = np.random.default_rng(7)

    def walk(node, key=None):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        if key in MIXER_VECTORS:
            v = rng.normal(size=node.shape).astype(node.dtype) * 0.3
            return 1 + v if key == "norm_scale" else v
        return node
    return walk(p_np)


def reference_sequence(jc, p_np, jb, max_len) -> list:
    """The reference's logits for ``ranks.serve_sequence``'s calls."""
    jm, jp = jbuild(jc), jax.tree.map(jnp.asarray, p_np)
    out = []
    jl, st = jm.prefill(jp, jb, max_len=max_len,
                        lengths=jnp.asarray(np.array([6, 3], np.int32)))
    out.append(jl)
    jl, st = jm.decode_step(jp, st, jnp.asarray(np.array([[5], [9]],
                                                         np.int32)))
    out.append(jl)
    chunk = jnp.asarray(np.random.default_rng(3).integers(0, 256, (2, 4))
                        .astype(np.int32))
    jl, st = jm.extend(jp, st, chunk,
                       lengths=jnp.asarray(np.array([4, 2], np.int32)))
    out.append(jl)
    jl, st = jm.extend(jp, st, chunk)
    out.append(jl)
    return [np.asarray(a, np.float32) for a in out]


def reference_engine(cases: Cases) -> list:
    eng = jserve.ServeEngine(
        jbuild(cases.jc), jax.tree.map(jnp.asarray, cases.engine_params),
        jserve.ServeConfig(n_slots=2, max_len=32, prefill_chunk=4,
                           chunks_per_step=2))
    reqs = [jserve.Request(uid=i, prompt=np.asarray(p, np.int32),
                           max_new=new, n_planes=b)
            for i, (p, new, b) in enumerate(TRAFFIC)]
    for r in reqs:
        assert eng.try_add(r)
    for _ in range(300):
        if all(r.done for r in reqs):
            break
        eng.step()
    return [(list(map(int, r.out)), r.result.planes_used_mean)
            for r in reqs]


@pytest.fixture(scope="module")
def cases():
    return Cases()


@pytest.fixture(scope="module")
def worlds(cases):
    """One spawned world per size, run on first use: every check's results,
    rank by rank."""
    done = {}

    def get(n):
        if n not in done:
            done[n] = run_world(
                ranks.split_world, n, backend="gloo", device="cpu",
                timeout=60, deadline=240,
                args=(n, combine_cases(), cases.models,
                      (cases.tc, cases.engine_params, TRAFFIC),
                      (cases.hybrid_cfg, cases.hybrid_params, TRAFFIC)))
        return done[n]
    return get


def close(port, ref, rel):
    port, ref = np.asarray(port, np.float32), np.asarray(ref, np.float32)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    np.testing.assert_allclose(port, ref, rtol=0,
                               atol=rel * max(float(np.abs(ref).max()), 1e-6))


# ------------------------------------------------------------ the combine

@pytest.mark.parametrize("n", [2, 4])
def test_combine_matches_attention_over_the_whole_ring(worlds, n):
    for i, case in enumerate(combine_cases()):
        whole = flash_attention(
            *(ranks.t(case[k]) for k in ("q", "k", "v", "q_pos")),
            ranks.t(case["k_pos"]).int(), causal=case["causal"],
            window=case["window"], chunk=case["chunk"]).numpy()
        for res in worlds(n):
            close(res["combine"][i], whole, REL)


# ------------------------------------------------------------ the model

@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("n", [2, 4])
def test_split_serving_matches_the_unsplit_port(worlds, cases, n, name):
    """Every rank's prefill, decode and extend logits."""
    rel = BF16_REL if name == "bf16" else REL
    want = cases.port[name][0]
    for res in worlds(n):
        for got, ref in zip(res["models"][name]["logits"], want):
            close(got, ref, rel)


@pytest.mark.parametrize("name", REF_CASES)
@pytest.mark.parametrize("n", [2, 4])
def test_split_serving_matches_the_reference(worlds, cases, n, name):
    for res in worlds(n):
        for got, ref in zip(res["models"][name]["logits"], cases.ref[name]):
            close(got, ref, REF_REL)


@pytest.mark.parametrize("name", F32_CASES)
@pytest.mark.parametrize("n", [2, 4])
def test_rings_split_along_their_slots(worlds, cases, n, name):
    """A ring of C slots is a ``KVShard`` of C/n on every rank where n
    divides C, the whole ring otherwise; the ranks' blocks in rank order
    are the unsplit port's ring, positions exactly."""
    _, want, _ = cases.port[name]
    res = worlds(n)
    for i, (_, k, v, pos) in enumerate(want):
        C = k.shape[1]
        kinds = {r["models"][name]["rings"][i][0] for r in res}
        if C % n:
            assert kinds == {"KVCache"}, (name, i, C)
            blocks = [r["models"][name]["rings"][i][1:] for r in res[:1]]
        else:
            assert kinds == {"KVShard"}, (name, i, C)
            blocks = [r["models"][name]["rings"][i][1:] for r in res]
        assert all(b[0].shape[1] == C // (len(blocks)) for b in blocks)
        got = [np.concatenate(parts, axis=1) for parts in zip(*blocks)]
        np.testing.assert_array_equal(got[2], pos)
        close(got[0], k, REL)
        close(got[1], v, REL)


@pytest.mark.parametrize("name", RECURRENT_CASES)
@pytest.mark.parametrize("n", [2, 4])
def test_recurrent_states_split_by_head_and_width(worlds, cases, n, name):
    """Where n divides the SSD heads, a rank's ``SSMState`` holds its H/n
    heads (B, H/n, P, N) and a conv tail of its x channels and the whole
    B/C (B, k-1, d_inner/n + 2N); where n divides the RG-LRU's width W,
    its ``RGLRUState`` holds W/n of ``h`` and of the conv tail; otherwise
    the state is whole.  The ranks' blocks in rank order rebuild the
    unsplit state, shapes exactly and values within ``REL``, and every
    rank's B/C tail is the unsplit one."""
    want = cases.port[name][2]
    cfg = cases.models[name]["cfg"]
    N = cfg.ssm_state
    res = [r["models"][name]["recurrent"] for r in worlds(n)]
    assert want and all(len(r) == len(want) for r in res)
    for i, (kind, *whole) in enumerate(want):
        parts = [r[i] for r in res]
        assert {p[0] for p in parts} == {kind}
        if kind == "SSMState":
            conv, ssm = whole
            splits = ssm.shape[1] % n == 0
            for p in parts:
                assert p[2].shape == (ssm.shape[0], ssm.shape[1] // n
                                      if splits else ssm.shape[1],
                                      *ssm.shape[2:])
            if not splits:
                for p in parts:
                    close(p[1], conv, REL)
                    close(p[2], ssm, REL)
                continue
            close(np.concatenate([p[2] for p in parts], axis=1), ssm, REL)
            xs = np.concatenate([p[1][..., :-2 * N] for p in parts], -1)
            close(xs, conv[..., :-2 * N], REL)
            for p in parts:
                close(p[1][..., -2 * N:], conv[..., -2 * N:], REL)
        else:
            conv, h = whole
            assert h.shape[1] % n == 0
            for p in parts:
                assert p[1].shape == (*conv.shape[:2], conv.shape[2] // n)
                assert p[2].shape == (h.shape[0], h.shape[1] // n)
            close(np.concatenate([p[1] for p in parts], -1), conv, REL)
            close(np.concatenate([p[2] for p in parts], -1), h, REL)


@pytest.mark.parametrize("n", [2, 4])
def test_a_rank_stores_its_model_slice(worlds, n):
    """olmo-1b (every leaf splits but the kv heads read by "repeat" on 4,
    which are halved): a rank holds 1/n of the parameters on 2 ranks and
    between 1/4 and 3/8 of them on 4."""
    share = {r["models"]["kv"]["share"] for r in worlds(n)}
    assert len(share) == 1
    share = share.pop()
    if n == 2:
        assert share == pytest.approx(0.5)
    else:
        assert 0.25 < share < 0.375


# ------------------------------------------------------------ the engine

@pytest.mark.parametrize("n", [2, 4])
def test_split_engine_matches_the_unsplit_and_reference_engines(worlds,
                                                                 cases, n):
    """Five requests through 2 slots with chunked, 2-lane admission and
    per-request plane budgets: every rank's streams and plane accounts
    equal the unsplit port engine's, the streams the reference engine's;
    each rank's pool rings hold 32/n slots."""
    plain = ranks.engine_streams(cases.tc, cases.engine_params, TRAFFIC,
                                 None)["streams"]
    ref = reference_engine(cases)
    assert [s for s, _ in plain] == [s for s, _ in ref]
    for res in worlds(n):
        e = res["engine"]
        assert e["streams"] == plain, res["rank"]
        for (_, pg), (_, pr) in zip(e["streams"], ref):
            assert pg == pytest.approx(pr, abs=1e-6), res["rank"]
        assert {(kind, k.shape[1]) for kind, k, _, _ in e["rings"]} == \
            {("KVShard", 32 // n)}


@pytest.mark.parametrize("n", [2, 4])
def test_split_hybrid_engine_matches_the_unsplit_engine(worlds, cases, n):
    """The hybrid (RG-LRU, RG-LRU, local attention; ReLU DSLOT MLPs) on the
    same five requests: every rank's streams and plane accounts equal the
    unsplit port engine's; each rank's pool holds rings of 32/n slots and
    RG-LRU states of 64/n channels."""
    plain = ranks.engine_streams(cases.hybrid_cfg, cases.hybrid_params,
                                 TRAFFIC, None)["streams"]
    for res in worlds(n):
        e = res["hybrid"]
        assert e["streams"] == plain, res["rank"]
        assert {(kind, k.shape[1]) for kind, k, _, _ in e["rings"]} == \
            {("KVShard", 32 // n)}
        assert {(kind, h.shape[-1]) for kind, _, h in e["recurrent"]} == \
            {("RGLRUState", 64 // n)}


@pytest.mark.parametrize("n", [2, 4])
def test_a_split_engine_serves_over_the_model_axis_only(worlds, n):
    """The parameters are cut over the mesh's "model" axis, so an engine
    asked to split over another axis raises instead of reading whole
    leaves as slices."""
    for res in worlds(n):
        assert "tp_axis 'data'" in res["other_axis"], res["other_axis"]


def test_a_split_ring_is_read_only_inside_model_shard():
    """A ``KVShard`` outside ``pspec.model_shard`` raises: a rank never
    serves part of a ring as if it were the whole."""
    cfg = cfg_pair("olmo-1b")[1]
    p = init_attention(cfg, torch.Generator().manual_seed(0), "cpu")
    ring = KVShard(k=torch.zeros(1, 4, 2, 16), v=torch.zeros(1, 4, 2, 16),
                   positions=torch.full((1, 4), -1, dtype=torch.int32))
    with pytest.raises(ValueError, match="model_shard"):
        attention_forward(p, torch.zeros(1, 1, cfg.d_model), cfg,
                          positions=torch.zeros((1, 1), dtype=torch.int32),
                          cache=ring)
