"""Port parity: quantization, prepare/execute and the fused one-shot matmul
(``repro_torch.kernels.ops``) against the JAX reference.

The reference executes with ``backend="pallas"`` (interpret mode on the
CPU); the port, given CPU tensors, runs the kernel's plain version.
Quantized values, prepared geometry, MSR bounds and every per-tile
statistic must be equal; float outputs agree within the stated tolerance.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch
import torch_one_thread  # noqa: F401  (PyTorch on one CPU thread)

from repro.kernels import ops as jops
from repro_torch.kernels import ops as tops
from repro_torch.layers import DslotDense


def _t(a, dtype=None):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _workload(seed=0, M=48, K=40, N=56, signed=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(0.2, 0.5, (M, K)).astype(np.float32)
    if not signed:
        x = np.maximum(x, 0)
    w = rng.normal(0, 0.05, (K, N)).astype(np.float32)
    w[:, : N // 2] -= 0.10                # clustered ReLU-dead columns
    w[:, N - 8:] = 0.0                    # an exactly-zero (inert) tile
    return rng, x, w


@pytest.mark.parametrize("signed", [False, True])
def test_quantize_and_calibrate_match_reference(signed):
    rng = np.random.default_rng(1)
    x = rng.normal(0.1, 0.7, (33, 17)).astype(np.float32)
    x[0, 0] = 0.5 * np.float32(x.max())   # ties round half to even
    jq, js = jops.quantize_activations(jnp.asarray(x), 8, signed=signed)
    tq, ts = tops.quantize_activations(_t(x), 8, signed=signed)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert float(ts) == float(js)
    jc = jops.calibrate_scale(jnp.asarray(x), 8, signed=signed)
    tc = tops.calibrate_scale(_t(x), 8, signed=signed)
    assert float(tc) == float(jc)
    jq, _ = jops.quantize_activations(jnp.asarray(x * 3), 8, signed=signed,
                                      scale=jc)
    tq, _ = tops.quantize_activations(_t(x * 3), 8, signed=signed, scale=tc)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))


@pytest.mark.parametrize("sort_columns,msr_bound,signed,block_k", [
    (False, True, False, None), (True, True, False, 16),
    (True, False, True, 24), (False, True, True, None)])
def test_prepare_matches_reference(sort_columns, msr_bound, signed, block_k):
    _, _, w = _workload(2)
    w[:, 3] = w[:, 5]                     # tied column sums sort stably
    kw = dict(sort_columns=sort_columns, msr_bound=msr_bound, signed=signed,
              block_m=16, block_n=8, block_k=block_k)
    jp = jops.dslot_prepare(jnp.asarray(w), backend="pallas", **kw)
    tp = tops.dslot_prepare(_t(w), **kw)
    assert (tp.block_k, tp.d_in, tp.d_out) == (jp.block_k, jp.d_in, jp.d_out)
    np.testing.assert_array_equal(tp.w.numpy(), np.asarray(jp.w))
    if sort_columns:
        np.testing.assert_array_equal(tp.inv_perm.numpy(),
                                      np.asarray(jp.inv_perm))
    else:
        assert tp.inv_perm is None and jp.inv_perm is None
    if msr_bound:
        np.testing.assert_array_equal(tp.msr_bound.numpy(),
                                      np.asarray(jp.msr_bound))
    else:
        assert tp.msr_bound is None
    # |W| column sums of 40 normal weights: a last-ulp difference at most
    np.testing.assert_allclose(tp.suffix_colsum.numpy(),
                               np.asarray(jp.suffix_colsum), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(tp.total_colsum.numpy(),
                               np.asarray(jp.total_colsum), rtol=1e-6)


def _assert_same(jres, tres, tol=1e-5):
    (jy, js), (ty, ts) = jres, tres
    for f in ("planes_used", "planes_bounded"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)), err_msg=f)
    assert ts.n_planes == js.n_planes
    # row_planes_used: means of small integers over the N tiles.  XLA's CPU
    # mean rounds 36/7 to 5.142858 where torch's division gives the correctly
    # rounded 5.142857, so one ulp apart
    np.testing.assert_allclose(ts.row_planes_used.numpy(),
                               np.asarray(js.row_planes_used), rtol=2.5e-7,
                               atol=0)
    np.testing.assert_allclose(float(ts.skipped_frac), float(js.skipped_frac),
                               rtol=1e-6, atol=1e-7)
    # outputs: 40-term f32 dot products in another order, times the step
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("sort_columns", [False, True])
@pytest.mark.parametrize("precision", ["full", "scalar", "rows"])
def test_execute_matches_reference(sort_columns, precision):
    rng, x, w = _workload(3)
    kw = dict(sort_columns=sort_columns, block_m=16, block_n=8, block_k=16)
    jp = jops.dslot_prepare(jnp.asarray(w), backend="pallas", **kw)
    tp = tops.dslot_prepare(_t(w), **kw)
    npl = {"full": None, "scalar": 3,
           "rows": rng.integers(1, 9, x.shape[0]).astype(np.int32)}[precision]
    jres = jops.dslot_execute(jp, jnp.asarray(x), n_planes=npl)
    tres = tops.dslot_execute(tp, _t(x), n_planes=None if npl is None
                              else _t(npl))
    _assert_same(jres, tres)
    if precision == "full":
        assert tres[1].planes_used.min() < 8, "termination must fire"


@pytest.mark.parametrize("relu,signed,msr_bound", [
    (False, False, True), (True, True, True), (True, False, False)])
def test_execute_modes_match_reference(relu, signed, msr_bound):
    """ReLU off (all planes run), signed activations, and no MSR bound;
    with a calibrated scale so both quantize against the same step."""
    _, x, w = _workload(4, signed=signed)
    kw = dict(relu=relu, signed=signed, msr_bound=msr_bound, block_m=16,
              block_n=8, block_k=None)
    scale = jops.calibrate_scale(jnp.asarray(x), 8, signed=signed)
    jp = jops.dslot_prepare(jnp.asarray(w), backend="pallas", **kw) \
        .with_scale(scale)
    tp = tops.dslot_prepare(_t(w), **kw).with_scale(float(scale))
    for npl in (8, 5):
        _assert_same(jops.dslot_execute(jp, jnp.asarray(x), n_planes=npl),
                     tops.dslot_execute(tp, _t(x), n_planes=npl))


def test_injected_partial_bound_mechanism():
    """Any (Nt,) bound table is honoured: per-tile planes_used equals
    min(bound, granted) on a non-ReLU run, as in the reference."""
    rng = np.random.default_rng(11)
    x = np.abs(rng.normal(size=(4, 16))).astype(np.float32)
    w = rng.normal(size=(16, 8)).astype(np.float32)
    table = np.asarray([0, 3, 5, 8], np.int32)
    jp = jops.dslot_prepare(jnp.asarray(w), relu=False, block_m=4,
                            block_n=2, backend="pallas")
    tp = tops.dslot_prepare(_t(w), relu=False, block_m=4, block_n=2)
    jres = jops.dslot_execute(
        dataclasses.replace(jp, msr_bound=jnp.asarray(table)), jnp.asarray(x))
    tres = tops.dslot_execute(dataclasses.replace(tp, msr_bound=_t(table)),
                              _t(x))
    assert tres[1].planes_used.tolist() == [[0, 3, 5, 8]]
    assert tres[1].planes_bounded.tolist() == [[8, 5, 3, 0]]
    _assert_same(jres, tres)


def test_fused_matmul_matches_reference_and_trims_grid():
    _, x, w = _workload(5)
    for D in (8, 4):
        jres = jops.dslot_matmul(jnp.asarray(x), jnp.asarray(w), n_planes=D,
                                 block_m=16, block_n=8, block_k=16,
                                 backend="pallas", sort_columns=True)
        tres = tops.dslot_matmul(_t(x), _t(w), n_planes=D, block_m=16,
                                 block_n=8, block_k=16, sort_columns=True)
        _assert_same(jres, tres)
    # every column inert: the static plane depth shrinks to one plane
    y, st = tops.dslot_matmul(_t(x), torch.zeros(40, 8), block_m=16,
                              block_n=8)
    _, jst = jops.dslot_matmul(jnp.asarray(x), jnp.zeros((40, 8)), block_m=16,
                               block_n=8, backend="jnp")
    assert st.n_planes == jst.n_planes == 1
    assert float(y.abs().max()) == 0.0


def test_row_budget_rows_equal_scalar_runs():
    """Each row under a per-row budget equals that row under a scalar run at
    the same budget (per-request precision inside a pooled batch)."""
    rng, x, w = _workload(7, M=32)
    tp = tops.dslot_prepare(_t(w), block_m=16, block_n=8, block_k=16)
    budget = rng.integers(2, 9, 32).astype(np.int32)
    yv, sv = tops.dslot_execute(tp, _t(x), n_planes=_t(budget))
    assert sv.row_planes_used.shape == (32,)
    for r in (0, 9, 31):
        yr, _ = tops.dslot_execute(tp, _t(x), n_planes=int(budget[r]))
        assert torch.equal(yv[r], yr[r])


def test_precision_changes_never_reprepare():
    """One prepare per layer, then any number of executions at any runtime
    precision — scalar ints, scalar tensors and per-row vectors."""
    layer = DslotDense(32, 32, name="once", block_m=16, block_n=16)
    n0 = tops.prepare_call_count()
    params = layer.init(torch.Generator().manual_seed(0), device="cpu")
    assert tops.prepare_call_count() - n0 == 1
    x = torch.randn((16, 32), generator=torch.Generator().manual_seed(1))
    x = x.clamp_min(0)
    outs = [layer.apply(params, x, n_planes=D)[0]
            for D in (8, 6, 4, 2, torch.tensor(3), torch.arange(16) % 8 + 1)]
    assert tops.prepare_call_count() - n0 == 1, \
        "runtime precision must not re-prepare"
    assert (outs[0] - outs[3]).abs().max() > 0


@pytest.mark.parametrize("n_bits", [2, 4, 8])
@pytest.mark.parametrize("signed,relu", [(False, False), (False, True),
                                         (True, False), (True, True)])
def test_msr_bound_exact_every_mode(n_bits, signed, relu):
    """The weight-side bound is a pure work saving: outputs with it equal
    outputs without it at every precision, it never adds planes, and the
    port's per-tile accounting equals the reference replay's."""
    rng = np.random.default_rng(n_bits)
    x = rng.normal(size=(6, 16)).astype(np.float32)
    x = x if signed else np.abs(x)
    w = rng.normal(size=(16, 8)).astype(np.float32)
    w[:, 2:4] = 0.0
    w[:, 6:] = -np.abs(w[:, 6:])
    kw = dict(n_bits=n_bits, relu=relu, signed=signed, block_m=2,
              block_n=2)
    for n_planes in sorted({1, n_bits // 2, n_bits} - {0}):
        yb, sb = tops.dslot_execute(tops.dslot_prepare(_t(w), **kw), _t(x),
                                    n_planes=n_planes)
        yu, su = tops.dslot_execute(
            tops.dslot_prepare(_t(w), msr_bound=False, **kw), _t(x),
            n_planes=n_planes)
        assert torch.equal(yb, yu)
        assert int(sb.planes_used.sum()) <= int(su.planes_used.sum())
        assert int(sb.planes_bounded.sum()) > 0
        # the reference's own replay backend, same inputs
        jres = jops.dslot_execute(
            jops.dslot_prepare(jnp.asarray(w), backend="jnp", **kw),
            jnp.asarray(x), n_planes=n_planes)
        _assert_same(jres, (yb, sb))
