"""Port parity for the digit-serial convolution simulator
(``repro_torch.core.conv``): ``extract_windows``, ``dslot_conv2d_stats``
and ``sip_conv2d`` against the reference on seeded numpy inputs, then the
properties of ``tests/test_conv.py`` on the port.

Every Algorithm-1 report field must be equal, dtype included.  ``y_conv``
is an exact integer SOP times one f32 scale in both packages and
``y_pooled`` a ReLU and max of it, so both are held to one f32 ulp
(rtol 2^-23): equal unless the scale product rounds the other way.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import dslot_conv2d_stats as j_stats
from repro.core import extract_windows as j_windows
from repro.core import sip_conv2d as j_sip
from repro_torch.core import conv as tconv
from repro_torch.core import (dslot_conv2d_stats, extract_windows,
                              sip_conv2d)

ULP = 2.0 ** -23
REPORT_FIELDS = ("is_negative", "term_digit", "cycles_used", "cycles_saved",
                 "savings_frac")


def _inputs(seed, shape, m, k, wmean, wstd):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, size=shape).astype(np.float32)
    x[:, :2] = 0.0                               # all-zero windows: SOP 0
    w = rng.normal(wmean, wstd, size=(m, k, k)).astype(np.float32)
    return x, w


def test_extract_windows_matches_reference():
    x = np.arange(2 * 8 * 9, dtype=np.int32).reshape(2, 8, 9)
    out = extract_windows(torch.as_tensor(x), 3)
    assert out.shape == (2, 6, 7, 9) and out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(),
                                  np.asarray(j_windows(jnp.asarray(x), 3)))
    np.testing.assert_array_equal(out[1, 2, 3].numpy(),
                                  x[1, 2:5, 3:6].reshape(-1))


@pytest.mark.parametrize("shape,m,k,wmean,wstd,n_bits,pool", [
    ((2, 12, 12), 3, 5, -0.05, 0.25, 8, 2),
    ((1, 9, 10), 4, 3, 0.0, 0.3, 6, 3),
])
def test_dslot_conv2d_stats_matches_reference(shape, m, k, wmean, wstd,
                                              n_bits, pool):
    x, w = _inputs(k, shape, m, k, wmean, wstd)
    ref = j_stats(jnp.asarray(x), jnp.asarray(w), n_bits=n_bits, pool=pool)
    out = dslot_conv2d_stats(torch.as_tensor(x), torch.as_tensor(w),
                             n_bits=n_bits, pool=pool)
    assert tuple(out.schedule) == tuple(ref.schedule)
    assert out.report.cycles_full == ref.report.cycles_full
    for field in REPORT_FIELDS:
        a, b = getattr(out.report, field), np.asarray(getattr(ref.report,
                                                              field))
        assert a.dtype == getattr(torch, b.dtype.name), field
        np.testing.assert_array_equal(a.numpy(), b, err_msg=field)
    assert 0 < float(out.report.negative_rate) < 1
    for name in ("y_conv", "y_pooled", "x_scale", "w_scale"):
        np.testing.assert_allclose(getattr(out, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=ULP, atol=0, err_msg=name)


def test_sip_conv2d_matches_reference():
    x, w = _inputs(2, (2, 12, 12), 3, 5, -0.05, 0.25)
    out = sip_conv2d(torch.as_tensor(x), torch.as_tensor(w))
    ref = j_sip(jnp.asarray(x), jnp.asarray(w))
    assert out.dtype == torch.float32 and out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=ULP,
                               atol=0)


@pytest.mark.parametrize("chunk", [7, 50])
def test_window_chunks_change_nothing(monkeypatch, chunk):
    x, w = _inputs(4, (2, 10, 10), 3, 3, -0.05, 0.3)
    x, w = torch.as_tensor(x), torch.as_tensor(w)
    whole = dslot_conv2d_stats(x, w)
    monkeypatch.setattr(tconv, "WINDOW_CHUNK", chunk)
    part = dslot_conv2d_stats(x, w)
    assert torch.equal(part.y_conv, whole.y_conv)
    for field in REPORT_FIELDS:
        assert torch.equal(getattr(part.report, field),
                           getattr(whole.report, field)), field


def test_non_square_kernel_raises():
    with pytest.raises(ValueError, match="square"):
        dslot_conv2d_stats(torch.rand((1, 8, 8)), torch.rand((2, 3, 4)))


# ------------------------------------------------------------ properties

def test_dslot_equals_sip_bit_exact():
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.uniform(0, 1, size=(2, 14, 14)), dtype=torch.float32)
    w = torch.as_tensor(rng.normal(0, 0.3, size=(4, 5, 5)), dtype=torch.float32)
    assert torch.equal(dslot_conv2d_stats(x, w).y_conv, sip_conv2d(x, w))


def test_dslot_matches_float_conv_to_quantization():
    from numpy.lib.stride_tricks import sliding_window_view

    rng = np.random.default_rng(1)
    x = rng.uniform(0, 1, size=(2, 12, 12)).astype(np.float32)
    w = rng.normal(0, 0.25, size=(3, 5, 5)).astype(np.float32)
    res = dslot_conv2d_stats(torch.as_tensor(x), torch.as_tensor(w))
    win = sliding_window_view(x, (5, 5), axis=(1, 2))       # (B,8,8,5,5)
    ref = np.einsum("bijkl,mkl->bijm", win, w)
    err = np.abs(res.y_conv.numpy() - ref).max()
    assert err < 0.05 * max(np.abs(ref).max(), 1.0), err


def test_fused_relu_maxpool():
    rng = np.random.default_rng(2)
    x = torch.as_tensor(rng.uniform(0, 1, size=(1, 12, 12)), dtype=torch.float32)
    w = torch.as_tensor(rng.normal(0, 0.3, size=(2, 5, 5)), dtype=torch.float32)
    res = dslot_conv2d_stats(x, w, pool=2)
    relu = np.maximum(res.y_conv.numpy(), 0.0)
    B, H, W, M = relu.shape
    pooled = relu[:, : H // 2 * 2, : W // 2 * 2].reshape(
        B, H // 2, 2, W // 2, 2, M).max(axis=(2, 4))
    np.testing.assert_array_equal(res.y_pooled.numpy(), pooled)


def test_termination_stats_are_consistent():
    rng = np.random.default_rng(3)
    x = torch.as_tensor(rng.uniform(0, 1, size=(1, 12, 12)), dtype=torch.float32)
    w = torch.as_tensor(rng.normal(-0.15, 0.2, size=(2, 5, 5)),
                        dtype=torch.float32)
    res = dslot_conv2d_stats(x, w)
    neg = res.y_conv.numpy() < 0
    fired = res.report.is_negative.numpy()
    assert (fired <= neg).all()                   # soundness
    assert fired.mean() > 0.2                     # actually fires here
    saved = res.report.cycles_saved.numpy()
    assert (saved[fired] > 0).all()
    assert (saved[~fired] == 0).all()
