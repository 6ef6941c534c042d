"""Port parity: im2col, the DSLOT layer API, the precision scope and the
runtime policies (``repro_torch.layers``, ``repro_torch.core.conv``,
``repro_torch.runtime``) against the JAX reference.

The reference layers run with ``use_pallas=True`` (interpret mode on the
CPU); the port's layers, given CPU tensors, run the kernel's plain version.
Both receive the same numpy weights and inputs.  Per-tile statistics must
be equal; outputs agree within the stated tolerance.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch_one_thread  # noqa: F401  (PyTorch on one CPU thread)

from repro.core.conv import im2col as jim2col
from repro.layers import DslotConv2d as JConv
from repro.layers import DslotDense as JDense
from repro.models import stats as jstats
from repro.runtime import (AdaptiveBudget as JAdaptive, PerLayerSchedule as
                           JSchedule, PolicyFeedback as JFeedback,
                           precision_scope as jscope)
from repro_torch.convert import layer_params
from repro_torch.core.conv import im2col as tim2col
from repro_torch.layers import DslotConv2d as TConv
from repro_torch.layers import DslotDense as TDense
from repro_torch.models import stats as tstats
from repro_torch.runtime import (AdaptiveBudget as TAdaptive,
                                 PerLayerSchedule as TSchedule,
                                 PolicyFeedback as TFeedback,
                                 precision_scope as tscope)


def _t(a, dtype=None):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _same_stats(js, ts):
    assert ts.name == js.name and ts.n_planes == js.n_planes
    np.testing.assert_array_equal(ts.planes_used.numpy(),
                                  np.asarray(js.planes_used))
    np.testing.assert_array_equal(ts.planes_bounded.numpy(),
                                  np.asarray(js.planes_bounded))
    np.testing.assert_allclose(float(ts.skipped_frac), float(js.skipped_frac),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("shape,k,stride,padding", [
    ((2, 9, 9, 3), 3, 1, "valid"), ((2, 9, 9, 3), 3, 2, "valid"),
    ((2, 9, 9, 3), 3, 2, "same"), ((1, 8, 10, 2), 5, 2, "same"),
    ((1, 7, 7, 1), 4, 3, "same"), ((2, 6, 6, 3), 2, 2, "same")])
def test_im2col_matches_reference(shape, k, stride, padding):
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    np.testing.assert_array_equal(
        tim2col(_t(x), k, stride, padding).numpy(),
        np.asarray(jim2col(jnp.asarray(x), k, stride, padding)))


def test_im2col_bad_padding_raises():
    with pytest.raises(ValueError, match="padding"):
        tim2col(torch.zeros((1, 8, 8, 1)), 3, padding="reflect")


def test_dense_matches_reference_with_precision_scope():
    rng = np.random.default_rng(1)
    w = rng.normal(0, 48 ** -0.5, (48, 64)).astype(np.float32)
    w[:, :24] -= 0.15                     # dead columns for termination
    x = np.maximum(rng.normal(size=(3, 10, 48)), 0).astype(np.float32)
    kw = dict(d_in=48, d_out=64, name="d", block_m=16, block_n=16,
              block_k=16, sort_columns=True)
    jl, tl = JDense(use_pallas=True, **kw), TDense(**kw)
    jp, tp = jl.prepare({"w": jnp.asarray(w)}), tl.prepare(
        layer_params({"w": w}, device="cpu"))
    per_req = np.asarray([8, 3, 5], np.int32)
    for npl_j, npl_t, scope in ((None, None, None), (4, 4, None),
                                (None, None, {"d": 6, "*": 2}),
                                (None, None, 3),
                                (jnp.asarray(per_req), _t(per_req), None)):
        if scope is None:
            jy, js = jl.apply(jp, jnp.asarray(x), n_planes=npl_j)
            ty, ts = tl.apply(tp, _t(x), n_planes=npl_t)
        else:
            with jscope(scope):
                jy, js = jl.apply(jp, jnp.asarray(x))
            with tscope(scope):
                ty, ts = tl.apply(tp, _t(x))
        assert ty.shape == (3, 10, 64)
        _same_stats(js, ts)
        # 48-term dot products in another order: 1e-5 relative
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                                   atol=1e-5)
    assert ts.planes_used.min() < ts.n_planes, "termination must fire"


def test_dense_calibrated_bf16_weights_match_reference():
    """bf16 weights are prepared in f32 by both packages; a calibrated
    scale is carried over as a float."""
    rng = np.random.default_rng(2)
    w32 = rng.normal(0, 0.1, (32, 16)).astype(np.float32)
    x = np.maximum(rng.normal(size=(20, 32)), 0).astype(np.float32)
    kw = dict(d_in=32, d_out=16, name="h", relu=False, block_m=16,
              block_n=8)
    jl, tl = JDense(use_pallas=True, **kw), TDense(**kw)
    jw = jnp.asarray(w32, jnp.bfloat16)
    jp = jl.calibrate(jl.prepare({"w": jw}), jnp.asarray(x))
    tp = tl.calibrate(tl.prepare(layer_params({"w": jw}, device="cpu")),
                      _t(x))
    assert tp["w"].dtype == torch.bfloat16
    assert float(tp["dslot"].x_scale) == float(jp["dslot"].x_scale)
    jy, js = jl.apply(jp, jnp.asarray(x))
    ty, ts = tl.apply(tp, _t(x))
    _same_stats(js, ts)
    assert (ts.planes_used == 8).all()    # no ReLU: every plane runs
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("padding,stride", [("valid", 1), ("valid", 2),
                                            ("same", 2)])
def test_conv2d_matches_reference(padding, stride):
    rng = np.random.default_rng(3)
    w = rng.normal(0, 27 ** -0.5, (3, 3, 3, 4)).astype(np.float32)
    x = rng.uniform(0, 1, (2, 9, 9, 3)).astype(np.float32)
    kw = dict(in_channels=3, out_channels=4, kernel_size=3, stride=stride,
              padding=padding, name="c", block_m=16, block_n=4)
    jl, tl = JConv(use_pallas=True, **kw), TConv(**kw)
    jp = jl.calibrate(jl.prepare({"w": jnp.asarray(w)}), jnp.asarray(x))
    tp = tl.calibrate(tl.prepare(layer_params({"w": w}, device="cpu")),
                      _t(x))
    for npl in (None, 4, np.asarray([2, 7], np.int32)):
        jy, js = jl.apply(jp, jnp.asarray(x), n_planes=None if npl is None
                          else jnp.asarray(npl))
        ty, ts = tl.apply(tp, _t(x), n_planes=None if npl is None
                          else _t(npl))
        assert ty.shape == jy.shape
        _same_stats(js, ts)
        np.testing.assert_array_equal(ts.row_planes_used.numpy(),
                                      np.asarray(js.row_planes_used))
        # 27-term dot products in another order
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                                   atol=1e-5)


def test_stats_side_channel_keys_match_reference():
    w = np.random.default_rng(4).normal(size=(32, 32)).astype(np.float32)
    x = np.abs(np.random.default_rng(5).normal(size=(16, 32))).astype(
        np.float32)
    kw = dict(d_in=32, d_out=32, name="probe", block_m=16, block_n=16)
    with jstats.collect() as jsink:
        JDense(**kw).apply({"w": jnp.asarray(w)}, jnp.asarray(x))
    with tstats.collect() as tsink:
        TDense(**kw).apply({"w": _t(w)}, _t(x))
    assert set(tsink) == set(jsink)
    for key in tsink:
        np.testing.assert_allclose(np.asarray(tsink[key][0]),
                                   np.asarray(jsink[key][0]), rtol=1e-6)


def test_runtime_policies_match_reference():
    sched = dict(schedule={"conv1": 8, "dense1": 4}, default=6)
    assert TSchedule(**sched).next_precision() == \
        JSchedule(**sched).next_precision()
    ja, ta = JAdaptive(plane_budget=4.0), TAdaptive(plane_budget=4.0)
    for used in (8.0, 2.0, 5.5, 1.0, 7.0):
        n = ja.next_precision()
        assert ta.next_precision() == n
        ja.observe(JFeedback(n_planes=n, planes_used_mean=used,
                             skipped_frac=0.0))
        ta.observe(TFeedback(n_planes=n, planes_used_mean=used,
                             skipped_frac=0.0))
        assert ta.cost_ratio == ja.cost_ratio


def test_layer_init_is_seeded_and_prepared():
    g = torch.Generator().manual_seed(0)
    p1 = TDense(8, 4, block_m=4, block_n=4).init(g, device="cpu")
    p2 = TDense(8, 4, block_m=4, block_n=4).init(
        torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(p1["w"], p2["w"]) and "dslot" in p1
    pc = TConv(2, 3, 3, block_m=4, block_n=3).init(g, device="cpu")
    assert pc["w"].shape == (3, 3, 2, 3)
    assert pc["dslot"].w.shape[0] == 18
    # the reference's random stream differs; its init only fixes the layout
    jc = JConv(2, 3, 3, block_m=4, block_n=3).init(jax.random.PRNGKey(0))
    assert tuple(jc["w"].shape) == tuple(pc["w"].shape)
