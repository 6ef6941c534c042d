"""Port parity: the FSDP x TP sharding rules (``repro_torch.train.
sharding``), gradient compression (``repro_torch.distributed.
compression``) and the fault-tolerance monitors (``repro_torch.distributed.
fault_tolerance``) against the JAX reference, in process (the rules take a
mesh's axis sizes only, so no world is needed).

* Every leaf of every architecture's reduced parameter tree gets the
  reference's ``param_pspec(path, leaf)(fsdp, tp)`` followed by
  ``sanitize_spec``, as plain data (``tuple`` of a ``PartitionSpec``), on
  the production meshes and a small one; ``batch_pspec`` and
  ``make_batch_shardings`` likewise.
* int8 and top-k compression on seeded numpy gradients and residuals:
  ``scale``, the top-k indices and values, and both decompressions equal
  the reference's exactly; int8 ``q`` equal except where |x / scale| lies
  within one f32 ulp of a .5 rounding boundary (there XLA's and PyTorch's
  divisions may round the quotient to either side), a count the test
  states and bounds.
* ``StragglerMonitor`` and ``HeartbeatTracker`` equal the reference's on
  its test sequence and on seeded random ones.
"""

import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch_one_thread  # noqa: F401  (PyTorch on one CPU thread)
from jax.sharding import PartitionSpec as JP

from repro.configs.registry import ARCHS as JARCHS
from repro.distributed import compression as jcomp
from repro.distributed import fault_tolerance as jft
from repro.models.model_zoo import build_model as jbuild
from repro.train import sharding as jsh
from repro_torch.configs.registry import ARCHS
from repro_torch.distributed import compression as tcomp
from repro_torch.distributed import fault_tolerance as tft
from repro_torch.models.model_zoo import build_model
from repro_torch.train import sharding as tsh
from repro_torch.tree import flatten_with_path, tree_map

MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "4x2": {"data": 4, "model": 2}}


class FakeMesh:
    """The reference test's mesh stand-in: axis sizes by name."""

    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


# ------------------------------------------------------------ rules

def ref_specs(arch, mesh) -> dict:
    """``{path: tuple(spec)}`` of the reference's rules on its own
    parameter tree (shapes only)."""
    jc = JARCHS[arch].reduced()
    tree = jax.eval_shape(lambda: jbuild(jc).init(jax.random.PRNGKey(0)))
    fsdp, tp = jsh.mesh_axes(mesh)
    f = fsdp if fsdp else None
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        spec = jsh.sanitize_spec(mesh, jsh.param_pspec(path, leaf)(f, tp),
                                 leaf.shape)
        out[jsh._path_str(path)] = tuple(spec)
    return out


@pytest.fixture(scope="module")
def port_params():
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = build_model(ARCHS[arch].reduced()).init(
                torch.Generator().manual_seed(0), device="cpu")
        return cache[arch]
    return get


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(JARCHS))
def test_param_specs_match_reference(port_params, arch, mesh):
    fake = FakeMesh(MESHES[mesh])
    params = port_params(arch)
    specs = tsh.make_param_shardings(fake, params)
    by_id = {}
    tree_map(lambda p, s: by_id.__setitem__(id(p), s), params, specs)
    mine = {path: by_id[id(p)] for path, p in flatten_with_path(params)}
    want = ref_specs(arch, fake)
    assert mine == want
    # the rules shard something on every architecture
    assert any(e is not None for s in mine.values() for e in s)


@pytest.mark.parametrize("path,shape", [
    ("decoder/rest/0/attn/wq/w", (512, 512)),
    ("decoder/groups/0/attn/wq/w", (8, 512, 512)),
    ("decoder/groups/0/mlp/down/w", (8, 2048, 512)),
    ("decoder/groups/0/moe/up", (8, 4, 64, 128)),
    ("decoder/rest/0/mixer/w_in", (512, 1024)),
    ("decoder/rest/0/mixer/A_log", (16,)),
    ("decoder/rest/0/norm1/scale", (512,)),
    ("embed/embedding", (49155, 1024)),
    ("not/a/rule", (3, 4))])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_single_rules_and_sanitize_match_reference(path, shape, mesh):
    """The reference test's paths, through the rule and sanitize, and the
    rule alone (granite's vocab 49155 does not divide 16)."""
    fake = FakeMesh(MESHES[mesh])
    leaf = np.zeros(shape, np.float32)
    jpath = tuple(type("K", (), {"key": k})() for k in path.split("/"))
    fsdp, tp = jsh.mesh_axes(fake)
    assert tsh.mesh_axes(fake) == (fsdp, tp)
    for f in (("data",), fsdp):
        ref = jsh.param_pspec(jpath, leaf)(f, tp)
        got = tsh.param_pspec(path, leaf)(f, tp)
        assert got == tuple(ref)
        assert tsh.param_pspec(jpath, leaf)(f, tp) == tuple(ref)
        assert tsh.sanitize_spec(fake, got, shape) == tuple(
            jsh.sanitize_spec(fake, ref, shape))


@pytest.mark.parametrize("global_batch", [1, 6, 8, 16, 32, 48, 512])
@pytest.mark.parametrize("mesh", sorted(MESHES) + ["model only"])
def test_batch_pspec_matches_reference(mesh, global_batch):
    fake = FakeMesh(MESHES.get(mesh, {"model": 4}))
    assert tsh.batch_pspec(fake, global_batch) == tuple(
        jsh.batch_pspec(fake, global_batch))


@pytest.mark.parametrize("batch_axis", [0, 1])
def test_make_batch_shardings_matches_reference(batch_axis):
    """On a real one-device mesh (the reference builds ``NamedSharding``s)
    and on the fake meshes against the reference's rule written out."""
    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    batch = {"tokens": np.zeros((2, 8, 16), np.int32),
             "scalar": np.zeros((), np.float32),
             "vec": np.zeros((8,), np.float32)}
    ref = jsh.make_batch_shardings(jmesh, batch, 8, batch_axis=batch_axis)
    got = tsh.make_batch_shardings(FakeMesh({"data": 1, "model": 1}), batch,
                                   8, batch_axis=batch_axis)
    assert got == {k: tuple(v.spec) for k, v in ref.items()}
    for name, shape in MESHES.items():
        fake = FakeMesh(shape)
        axes = tuple(jsh.batch_pspec(fake, 32))[:1]
        got = tsh.make_batch_shardings(fake, batch, 32,
                                       batch_axis=batch_axis)
        for k, leaf in batch.items():
            want = () if leaf.ndim <= batch_axis or not axes else tuple(
                JP(*((None,) * batch_axis), axes[0]))
            assert got[k] == want, (name, k)
    assert tsh.replicated(jmesh) == tuple(JP())


# ------------------------------------------------------------ compression

def grads_np(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(0, 1, (64, 64)).astype(np.float32),
            "b": (rng.normal(0, 1e-3, (300,))).astype(np.float32),
            "stack": [rng.normal(0, 5, (3, 5, 7)).astype(np.float32)]}


def to_j(tree):
    return jax.tree.map(jnp.asarray, tree)


def to_t(tree):
    return tree_map(torch.from_numpy, tree)


def np_of(tree):
    return jax.tree.leaves(jax.tree.map(np.asarray, tree))


def t_leaves(tree):
    """A port tree's leaves as numpy, in ``jax.tree.leaves`` order."""
    return [t.numpy() for _, t in flatten_with_path(tree)]


def near_half(x: np.ndarray, scale: float) -> np.ndarray:
    """Where |x / scale| is within one f32 ulp of a .5 boundary."""
    r = np.abs(x.astype(np.float64) / np.float64(scale))
    frac = r - np.floor(r)
    return np.abs(frac - 0.5) <= np.spacing(np.float32(r)).astype(np.float64)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_int8_compress_matches_reference(seed):
    g, r = grads_np(seed), grads_np(seed + 10)
    r = jax.tree.map(lambda a: a * np.float32(0.01), r)
    (jq, js), jef = jcomp.int8_compress(to_j(g), jcomp.EFState(to_j(r)))
    (tq, ts), tef = tcomp.int8_compress(to_t(g), tcomp.EFState(to_t(r)))
    n_boundary = n_diff = 0
    for a, b, s, x in zip(t_leaves(tq), np_of(jq), np_of(js),
                          jax.tree.leaves(jax.tree.map(np.add, g, r))):
        diff = a != b
        edge = near_half(x, float(s))
        n_boundary += int(edge.sum())
        n_diff += int(diff.sum())
        assert not (diff & ~edge).any()
        assert (np.abs(a.astype(np.int32) - b.astype(np.int32)) <= 1).all()
    # seeded inputs: at most a handful of entries sit on a boundary
    assert n_diff <= n_boundary <= 8, (n_diff, n_boundary)
    for a, b in zip(t_leaves(ts), np_of(js)):
        assert a == b
    # where q agrees, so do the residuals and the decompression
    same = [a == b for a, b in zip(t_leaves(tq), np_of(jq))]
    for a, b, m in zip(t_leaves(tef.residual), np_of(jef.residual), same):
        assert np.array_equal(a[m], b[m])
    dec_t = tcomp.int8_decompress((tq, ts))
    dec_j = jcomp.int8_decompress((jq, js))
    for a, b, m in zip(t_leaves(dec_t), np_of(dec_j), same):
        assert np.array_equal(a[m], b[m])
    assert tcomp.compressed_ratio(to_t(g), tq) == jcomp.compressed_ratio(
        to_j(g), jq)


@pytest.mark.parametrize("frac", [0.01, 0.1, 0.5])
@pytest.mark.parametrize("seed", [0, 3])
def test_topk_compress_matches_reference(seed, frac):
    g, r = grads_np(seed), grads_np(seed + 20)
    (jv, ji), jef = jcomp.topk_compress(to_j(g), jcomp.EFState(to_j(r)),
                                        frac=frac)
    (tv, ti), tef = tcomp.topk_compress(to_t(g), tcomp.EFState(to_t(r)),
                                        frac=frac)
    for a, b in zip(t_leaves(tv) + t_leaves(ti) + t_leaves(tef.residual),
                    np_of(jv) + np_of(ji) + np_of(jef.residual)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    dec_t = tcomp.topk_decompress((tv, ti), to_t(g))
    dec_j = jcomp.topk_decompress((jv, ji), to_j(g))
    for a, b in zip(t_leaves(dec_t), np_of(dec_j)):
        assert np.array_equal(a, b)
    assert tcomp.compressed_ratio(to_t(g), (tv, ti)) == \
        jcomp.compressed_ratio(to_j(g), (jv, ji))


@pytest.mark.parametrize("kind", ["int8", "topk"])
def test_error_feedback_holds(kind):
    """Decompressed payload plus the new residual equals the gradient plus
    the previous residual, within 1e-6 of each leaf's largest, over five
    steps of one gradient stream."""
    ef = tcomp.init_ef_state(to_t(grads_np(0)))
    for step in range(5):
        g = to_t(grads_np(100 + step))
        if kind == "int8":
            payload, new = tcomp.int8_compress(g, ef)
            dec = tcomp.int8_decompress(payload)
        else:
            payload, new = tcomp.topk_compress(g, ef, frac=0.1)
            dec = tcomp.topk_decompress(payload, g)
        for d, e, gg, r in zip(t_leaves(dec), t_leaves(new.residual),
                               t_leaves(g), t_leaves(ef.residual)):
            want = gg + r
            assert np.abs(d + e - want).max() <= 1e-6 * np.abs(want).max()
        ef = new


def test_reference_compression_cases_on_the_port():
    """``tests/test_distributed.py``'s int8 and top-k cases."""
    rng = np.random.default_rng(0)
    grads = {"w": torch.as_tensor(rng.normal(0, 1, (64, 64)),
                                  dtype=torch.float32)}
    ef = tcomp.init_ef_state(grads)
    acc = torch.zeros((64, 64))
    true = torch.zeros((64, 64))
    for _ in range(20):
        payload, ef = tcomp.int8_compress(grads, ef)
        acc = acc + tcomp.int8_decompress(payload)["w"]
        true = true + grads["w"]
    assert float((acc - true).abs().max() / true.abs().max()) < 0.01
    assert tcomp.compressed_ratio(grads, payload[0]) < 0.3

    rng = np.random.default_rng(1)
    grads = {"w": torch.as_tensor(rng.normal(0, 1, (128,)),
                                  dtype=torch.float32)}
    ef = tcomp.init_ef_state(grads)
    payload, ef = tcomp.topk_compress(grads, ef, frac=0.1)
    dec = tcomp.topk_decompress(payload, grads)
    assert int((dec["w"] != 0).sum()) <= 13
    np.testing.assert_allclose((dec["w"] + ef.residual["w"]).numpy(),
                               grads["w"].numpy(), atol=1e-6)


# ------------------------------------------------------------ monitors

def straggler_sequences():
    base = np.full(16, 1.0)
    slow = base.copy()
    slow[5] = 4.0
    yield "reference", [base, base] + [slow] * 10
    rng = np.random.default_rng(7)
    seq = []
    for i in range(40):
        t = rng.uniform(0.9, 1.1, 16)
        if i >= 10:
            t[3] *= 3.0
        if 20 <= i < 24:
            t[11] *= 5.0
        seq.append(t)
    yield "random", seq


@pytest.mark.parametrize("name,seq", list(straggler_sequences()))
@pytest.mark.parametrize("kw", [{}, {"factor": 1.2, "patience": 2,
                                     "ewma": 0.5}])
def test_straggler_monitor_matches_reference(name, seq, kw):
    ref = jft.StragglerMonitor(n_ranks=16, **kw)
    mine = tft.StragglerMonitor(n_ranks=16, **kw)
    flagged = []
    for t in seq:
        a, b = mine.observe(t), ref.observe(t)
        assert a == b
        assert np.array_equal(mine.mean, ref.mean)
        assert np.array_equal(mine.strikes, ref.strikes)
        flagged = a
    if name == "reference" and not kw:
        assert flagged == [5]


def test_heartbeat_tracker_matches_reference():
    rng = np.random.default_rng(11)
    ref, mine = jft.HeartbeatTracker(deadline_s=2.5), \
        tft.HeartbeatTracker(deadline_s=2.5)
    now = 0.0
    for _ in range(200):
        now += float(rng.uniform(0.0, 0.5))
        node = int(rng.integers(0, 8))
        if rng.uniform() < 0.8 or node < 6:
            ref.beat(node, now)
            mine.beat(node, now)
        assert mine.dead_nodes(now) == ref.dead_nodes(now)
        assert mine.last_seen == ref.last_seen
    err = tft.NodeFailure("host 3 died", lost_nodes=2)
    assert isinstance(err, RuntimeError) and err.lost_nodes == 2
    assert str(err) == str(jft.NodeFailure("host 3 died", lost_nodes=2))


# ------------------------------------------------------------ the split

# at model 16, per architecture (published widths): the (q heads, wk/wv,
# MLP d_ff, expert d_ff, vocab) reads of the sharded step's split compute
SPLIT16 = {
    "olmo-1b": ("split", "split", "split", None, "split"),
    "deepseek-67b": ("split", "part", "split", None, "split"),
    "mixtral-8x22b": ("split", "part", None, "split", "split"),
    "internvl2-26b": ("split", "part", "split", None, "whole"),
    "qwen2.5-3b": ("split", "part", "split", None, "split"),
    "granite-moe-1b-a400m": ("split", "part", None, "split", "whole"),
    "h2o-danube-3-4b": ("split", "part", "split", None, "split"),
    "seamless-m4t-medium": ("split", "split", "split", None, "whole"),
    "mamba2-780m": (None, None, None, None, "whole"),
    "recurrentgemma-2b": ("whole", "whole", "split", None, "split"),
}
# the recurrent mixers on 16 x 16: mamba2's 48 SSD heads and
# recurrentgemma's RG-LRU width of 2560 divide 16
MIXER16 = {
    "mamba2-780m": [(r"/mixer/(w_in|conv_w|conv_b|A_log|D_skip|dt_bias)$",
                     "part"), (r"/mixer/(norm_scale|w_out)$", "split")],
    "recurrentgemma-2b": [(r"/mixer/", "split")],
}


@pytest.mark.parametrize("arch", sorted(SPLIT16))
def test_model_reads_table(port_params, arch):
    """``sharding.model_reads`` on the 16 x 16 mesh with each published
    config (the leaf paths from the reduced tree): heads split where 16
    divides them, ``wk``/``wv`` split under "kv" and read in part under
    "repeat" (every 7 B-and-up model and qwen, granite, h2o), ``d_ff`` and
    the vocab split where 16 divides them (granite's 49155, internvl2's
    92553 and seamless' 256206 do not), recurrentgemma's 10 heads whole,
    the recurrent mixers split (``MIXER16``: mamba2's ``w_in``, conv and
    per-head leaves read in part, its ``norm_scale`` and ``w_out`` split;
    every RG-LRU leaf split), and norms, the router and ``wo``'s bias
    whole.  A SPLIT leaf's gather spec drops ``model``; every other spec is
    the storage spec."""
    fake = FakeMesh(MESHES["16x16"])
    cfg = ARCHS[arch]
    params = port_params(arch)
    reads = dict(flatten_with_path(tsh.model_reads(fake, cfg, params)))
    heads, kv, mlp, moe, vocab = SPLIT16[arch]
    want_of = [(r"/wq/(w|b)$|/wo/w$", heads), (r"/(wk|wv)/(w|b)$", kv),
               (r"/mlp/", mlp), (r"/moe/(up|gate|down)$", moe),
               (r"^(embed/embedding|head/w)$", vocab)] \
        + MIXER16.get(arch, [])
    seen = set()
    for path, got in reads.items():
        want = "whole"
        for pat, w in want_of:
            if re.search(pat, path):
                want = w
                seen.add(pat)
        assert got == want, (path, got, want)
    assert seen == {pat for pat, w in want_of if w is not None}
    specs = tsh.make_param_shardings(fake, params)
    gspecs = tsh.gather_specs(specs, tsh.model_reads(fake, cfg, params), fake)
    rows = []
    tree_map(lambda p, s, g, r: rows.append((s, g, r)), params, specs, gspecs,
             tsh.model_reads(fake, cfg, params))
    for s, g, r in rows:
        if r == "split":
            assert "model" in s, s
            assert g == tuple(None if e == "model" else e for e in s)
        else:
            assert g == s
