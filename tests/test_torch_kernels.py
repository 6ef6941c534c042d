"""Port parity: digit recoding, kernel oracles, MSR bounds and the
digit-serial matmul (``repro_torch.kernels.dslot_matmul``) against the JAX
reference.

The same numpy inputs go through both packages.  The reference's matmul runs
its Pallas kernel in interpret mode; the port's wrapper runs its plain
version, because the tensors lie on the CPU.  Integer results (digits,
planes, bounds, ``planes_used``, block geometry) must be equal; float
outputs agree within the tolerance stated at each assert.  The CUDA kernel
itself is held against the plain version in ``test_torch_cuda.py``.
"""

import importlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch
import torch_one_thread  # noqa: F401  (PyTorch on one CPU thread)

from repro.core import digits as jdigits
from repro.core import msr as jmsr
from repro.kernels import ref as jref
from repro_torch.core import digits as tdigits
from repro_torch.core import msr as tmsr
from repro_torch.kernels import dslot_matmul as tdm
from repro_torch.kernels import ref as tref

# the reference package's ``kernels`` exports a function of the same name
jdm = importlib.import_module("repro.kernels.dslot_matmul")


def _t(a, dtype=None):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _n(x):
    return np.asarray(x.float() if x.dtype == torch.bfloat16 else x)


# ------------------------------------------------ digits and oracles

@pytest.mark.parametrize("n_bits", list(range(1, 9)))
def test_digits_full_range(n_bits):
    """Every representable value at every width: the port's recoding equals
    the reference's, and the per-plane extraction equals the materializing
    encoder at every truncation depth."""
    q = np.arange(-(2 ** n_bits - 1), 2 ** n_bits, dtype=np.int32)
    sd = tdigits.fixed_to_sd(_t(q), n_bits)
    np.testing.assert_array_equal(
        _n(sd), np.asarray(jdigits.fixed_to_sd(jnp.asarray(q), n_bits)))
    for n_planes in range(1, n_bits + 1):
        planes = tref.make_planes(_t(q), n_bits, n_planes=n_planes)
        fused = torch.stack([tref.sd_digit_plane(_t(q), n_bits, d)
                             for d in range(n_planes)])
        np.testing.assert_array_equal(_n(fused), _n(planes))


def test_digit_plane_unsigned_storage():
    """An unsigned storage type gives the digits of the value: q is widened
    to int32 before abs/sign."""
    q = np.arange(0, 256, dtype=np.int32)
    for d in range(8):
        np.testing.assert_array_equal(
            _n(tref.sd_digit_plane(_t(q, torch.uint8), 8, d)),
            np.asarray(jref.sd_digit_plane(jnp.asarray(q), 8, d)))


@pytest.mark.parametrize("relu", [False, True])
def test_oracles_match_reference(relu):
    rng = np.random.default_rng(1)
    aq = rng.integers(-255, 256, (16, 24)).astype(np.int32)
    w = rng.normal(0, 0.1, (24, 12)).astype(np.float32)
    for n_planes in (8, 5):
        jp = jref.make_planes(jnp.asarray(aq), 8, n_planes=n_planes)
        tp = tref.make_planes(_t(aq), 8, n_planes=n_planes)
        np.testing.assert_array_equal(_n(tp), np.asarray(jp))
        np.testing.assert_array_equal(_n(tref.plane_value_ref(tp, 8)),
                                      np.asarray(jref.plane_value_ref(jp, 8)))
        # f32 sums of 24 products per plane: allow a few ulps of the output
        np.testing.assert_allclose(
            _n(tref.dslot_matmul_ref(tp, _t(w), 8, relu=relu)),
            np.asarray(jref.dslot_matmul_ref(jp, jnp.asarray(w), 8,
                                             relu=relu)),
            rtol=1e-6, atol=1e-5)
    csd = rng.integers(-1, 2, (9, 16, 24)).astype(np.int8)
    wi = rng.integers(-8, 9, (24, 12)).astype(np.float32)
    # integer weights: every step exact, so equal
    np.testing.assert_array_equal(
        _n(tref.csd_matmul_ref(_t(csd), _t(wi), 8, relu=relu)),
        np.asarray(jref.csd_matmul_ref(jnp.asarray(csd), jnp.asarray(wi), 8,
                                       relu=relu)))


# ------------------------------------------------ MSR analysis

def test_msr_profile_matches_reference():
    rng = np.random.default_rng(2)
    w = (rng.normal(size=(32, 32)) * 0.05).astype(np.float32)
    np.testing.assert_array_equal(
        _n(tmsr.quantize_weights(_t(w), 8)),
        np.asarray(jmsr.quantize_weights(jnp.asarray(w), 8)))
    wq = np.asarray([0, 1, -1, 7, 8, 127, -127], np.int32)
    np.testing.assert_array_equal(_n(tmsr.msr_depths(_t(wq), 8)),
                                  np.asarray(jmsr.msr_depths(jnp.asarray(wq))))
    for n_bits in (4, 8):
        assert tmsr.msr_histogram(_t(w), n_bits) == \
            jmsr.msr_histogram(jnp.asarray(w), n_bits)


@pytest.mark.parametrize("relu,signed", [(True, False), (True, True),
                                         (False, False), (False, True)])
def test_tile_plane_bound_matches_reference(relu, signed):
    """Zero tiles bound 0 always; non-positive tiles only under
    unsigned+ReLU; the same table from both packages."""
    rng = np.random.default_rng(5)
    w = np.zeros((8, 12), np.float32)
    w[:, 0:2] = rng.normal(size=(8, 2))
    w[:, 4:6] = -np.abs(rng.normal(size=(8, 2)))
    w[:, 8:12] = rng.normal(size=(8, 4))
    for bn in (2, 4):
        np.testing.assert_array_equal(
            _n(tmsr.tile_plane_bound(_t(w), bn, n_bits=8, relu=relu,
                                     signed=signed)),
            np.asarray(jmsr.tile_plane_bound(jnp.asarray(w), bn, n_bits=8,
                                             relu=relu, signed=signed)))


# ------------------------------------------------ geometry and tables

@pytest.mark.parametrize("n_bits,signed", [(8, False), (8, True), (7, False),
                                           (16, False), (12, True),
                                           (20, True), (20, False)])
def test_q_storage_dtype_matches_reference(n_bits, signed):
    td = tdm.q_storage_dtype(n_bits, signed)
    assert str(td).removeprefix("torch.") == \
        jdm.q_storage_dtype(n_bits, signed).name
    assert td.itemsize == jdm.q_storage_dtype(n_bits, signed).itemsize


def test_select_block_k_matches_reference():
    for K in (25, 128, 1152, 4096, 65536):
        for bm, bn in ((128, 8), (128, 128), (32, 32)):
            for wi, ai in ((4, 1), (2, 1), (4, 2)):
                assert tdm.select_block_k(K, bm, bn, wi, ai) == \
                    jdm.select_block_k(K, bm, bn, wi, ai)
    small = 2 * 1024 * 1024
    assert tdm.select_block_k(65536, 128, 128, 4, budget=small) == \
        jdm.select_block_k(65536, 128, 128, 4, budget=small)
    with pytest.raises(ValueError):
        tdm.select_block_k(1024, 1024, 1024, 4, budget=1024 * 1024)


def test_colsum_tables_match_reference():
    rng = np.random.default_rng(3)
    dyadic = (rng.integers(-64, 65, (96, 24)) / 64).astype(np.float32)
    normal = rng.normal(0, 0.05, (96, 24)).astype(np.float32)
    for bk in (96, 32, 16):
        for w, tol in ((dyadic, 0.0), (normal, 1e-6)):
            ts, tt = tdm.colsum_tables(_t(w), bk)
            js, jt = jdm.colsum_tables(jnp.asarray(w), bk)
            # dyadic sums are exact; normal ones may differ in the last ulp
            np.testing.assert_allclose(_n(ts), np.asarray(js), rtol=tol,
                                       atol=tol)
            np.testing.assert_allclose(_n(tt), np.asarray(jt), rtol=tol,
                                       atol=tol)


# ------------------------------------------------ the matmul, CPU path

def _workload(seed, M, K, N, signed=False, dead=True):
    rng = np.random.default_rng(seed)
    lo = -255 if signed else 0
    aq = rng.integers(lo, 256, (M, K)).astype(np.int32)
    w = rng.normal(0, 0.04, (K, N)).astype(np.float32)
    if dead:
        w[:, : N // 2] -= 0.08            # clustered ReLU-dead columns
    return rng, aq, w


CASES = [
    # (block_k, relu, signed, wdtype, runtime)
    (None, True, False, "f32", None),
    (16, True, False, "f32", None),
    (40, True, True, "f32", None),
    (16, False, False, "f32", None),
    (32, True, False, "bf16", None),
    (16, True, False, "f32", "scalar"),
    (16, True, True, "f32", "rows"),
    (None, True, False, "f32", "bound"),
]


@pytest.mark.parametrize("block_k,relu,signed,wdtype,runtime", CASES)
def test_matmul_matches_pallas_interpret(block_k, relu, signed, wdtype,
                                         runtime):
    """The port's wrapper on CPU tensors (its plain version) against the
    reference's Pallas kernel in interpret mode."""
    rng, aq, w = _workload(len(CASES) + (block_k or 0), 64, 96, 64,
                           signed=signed)
    jw = jnp.asarray(w, jnp.bfloat16 if wdtype == "bf16" else jnp.float32)
    tw = _t(w).to(torch.bfloat16 if wdtype == "bf16" else torch.float32)
    jkw, tkw = {}, {}
    if runtime == "scalar":
        jkw = tkw = {"n_planes_rt": 5}
    elif runtime == "rows":
        bud = rng.integers(1, 9, 64).astype(np.int32)
        jkw = {"n_planes_rt": int(bud.max()), "row_budget": jnp.asarray(bud)}
        tkw = {"n_planes_rt": int(bud.max()), "row_budget": _t(bud)}
    elif runtime == "bound":
        table = np.asarray([8, 0, 3, 8], np.int32)
        jkw = {"plane_bound": jnp.asarray(table)}
        tkw = {"plane_bound": _t(table)}
    q_dtype = np.int16 if signed else np.uint8
    ref = jdm.dslot_matmul_pallas(jnp.asarray(aq.astype(q_dtype)), jw,
                                  n_bits=8, relu=relu, block_m=32,
                                  block_n=16, block_k=block_k, **jkw)
    out = tdm.dslot_matmul_cuda(_t(aq.astype(q_dtype)), tw, n_bits=8,
                                relu=relu, block_m=32, block_n=16,
                                block_k=block_k, **tkw)
    assert out.out.dtype == torch.float32
    np.testing.assert_array_equal(_n(out.planes_used),
                                  np.asarray(ref.planes_used))
    # 96-term f32 dot products summed in another order: 1e-5 relative
    np.testing.assert_allclose(_n(out.out), np.asarray(ref.out),
                               rtol=1e-5, atol=1e-4)
    if relu and not signed and runtime is None:
        # unsigned digits on the negative-shifted columns: dead tiles exist
        assert _n(out.planes_used).min() < 8, "termination must fire"


# Geometries the card runs on cluster kernels (16 x 256 on the band
# kernel's 2-block clusters or cluster_kernel, a tall 512 x 8 tile on
# cluster_kernel): (block_m, block_n, M, K, N, block_k)
WALKED = [(16, 256, 32, 128, 512, 64), (512, 8, 512, 64, 16, 32)]


@pytest.mark.parametrize("block_m,block_n,M,K,N,block_k", WALKED)
def test_walked_tiles_match_pallas_interpret(block_m, block_n, M, K, N,
                                             block_k):
    """The port's plain version at the walked geometries, with row budgets,
    against the reference's Pallas kernel in interpret mode at the same
    geometry: ``planes_used`` equal, and tiles that stop early."""
    rng, aq, w = _workload(90 + block_m, M, K, N)
    bud = rng.integers(1, 9, M).astype(np.int32)
    kw = dict(n_bits=8, relu=True, block_m=block_m, block_n=block_n,
              block_k=block_k, n_planes_rt=int(bud.max()))
    ref = jdm.dslot_matmul_pallas(jnp.asarray(aq.astype(np.uint8)),
                                  jnp.asarray(w), row_budget=jnp.asarray(bud),
                                  **kw)
    out = tdm.dslot_matmul_cuda(_t(aq.astype(np.uint8)), _t(w),
                                row_budget=_t(bud), **kw)
    np.testing.assert_array_equal(_n(out.planes_used),
                                  np.asarray(ref.planes_used))
    # K-term f32 dot products summed in another order: 1e-5 relative
    np.testing.assert_allclose(_n(out.out), np.asarray(ref.out),
                               rtol=1e-5, atol=1e-4)
    # unsigned digits on the negative-shifted columns: dead tiles exist
    assert _n(out.planes_used).min() < int(bud.max()), "termination must fire"


def test_plain_entry_equals_wrapper_on_cpu():
    _, aq, w = _workload(4, 32, 48, 32)
    kw = dict(n_bits=8, relu=True, block_m=16, block_n=16, block_k=16)
    a = tdm.dslot_matmul_cuda(_t(aq), _t(w), **kw)
    b = tdm.dslot_matmul_plain(_t(aq), _t(w), **kw)
    np.testing.assert_array_equal(_n(a.out), _n(b.out))
    np.testing.assert_array_equal(_n(a.planes_used), _n(b.planes_used))


def test_static_truncation_matches_oracle():
    """Static plane depth D < n_bits on dyadic weights: every sum is exact,
    so the port equals the materializing oracle and the reference."""
    rng = np.random.default_rng(6)
    aq = rng.integers(-255, 256, (32, 64)).astype(np.int32)
    w = (rng.integers(-64, 65, (64, 32)) / 128).astype(np.float32)
    for D in (2, 4, 8):
        out = tdm.dslot_matmul_cuda(_t(aq), _t(w), n_planes=D, relu=True,
                                    block_m=16, block_n=16, block_k=16)
        ref = tref.dslot_matmul_ref(tref.make_planes(_t(aq), 8, D), _t(w), 8)
        np.testing.assert_array_equal(_n(out.out), _n(ref))
        jout = jdm.dslot_matmul_pallas(jnp.asarray(aq), jnp.asarray(w),
                                       n_planes=D, relu=True, block_m=16,
                                       block_n=16, block_k=16)
        np.testing.assert_array_equal(_n(out.planes_used),
                                      np.asarray(jout.planes_used))


def test_batched_entry_matches_reference():
    rng = np.random.default_rng(13)
    w = (rng.integers(-64, 65, (48, 32)) / 128).astype(np.float32)
    bq = rng.integers(-255, 256, (3, 32, 48)).astype(np.int32)
    budgets = np.asarray([3, 8, 5], np.int32)
    for rb in (None, budgets, np.repeat(budgets[:, None], 32, axis=1)):
        kw = dict(n_bits=8, relu=True, block_m=16, block_n=16, block_k=16,
                  n_planes_rt=8)
        ref = jdm.dslot_matmul_pallas_batched(
            jnp.asarray(bq), jnp.asarray(w),
            row_budget=None if rb is None else jnp.asarray(rb), **kw)
        out = tdm.dslot_matmul_cuda_batched(
            _t(bq), _t(w), row_budget=None if rb is None else _t(rb), **kw)
        assert out.out.shape == (3, 32, 32)
        assert out.planes_used.shape == (3, 2, 2)
        # dyadic weights: exact sums in any order
        np.testing.assert_array_equal(_n(out.out), np.asarray(ref.out))
        np.testing.assert_array_equal(_n(out.planes_used),
                                      np.asarray(ref.planes_used))


# ------------------------------------------------ the product identity

def _truncated_product(aq, w, n_bits, D, npl, budget, bound, block_n):
    """A layer without ReLU is one product: out = t @ w with
    t = sign(q) * (|q| with every bit below plane e cleared) and
    e = min(D, npl, budget[m], bound[tile of n]); per-tile planes_used is
    min(D, npl, bound[j]).  Summed in float64 column by column."""
    M, _ = aq.shape
    N = w.shape[1]
    e_row = np.minimum(min(D, npl), np.full(M, D) if budget is None
                       else budget)
    out = np.zeros((M, N))
    for n in range(N):
        e = np.minimum(e_row, bound[n // block_n])[:, None]
        keep = np.where(e > 0, ~((1 << (n_bits - e)) - 1), 0)
        t = np.sign(aq) * (np.abs(aq) & keep)
        out[:, n] = t.astype(np.float64) @ w[:, n].astype(np.float64)
    used = np.minimum(min(D, npl), bound)
    return out, np.broadcast_to(used, (M // 16, N // block_n))


PRODUCT_CASES = [(8, npl, npl % 2 == 1) for npl in range(1, 9)] + \
    [(4, npl, npl % 2 == 0) for npl in range(1, 5)]


@pytest.mark.parametrize("n_bits,npl,signed", PRODUCT_CASES)
def test_no_relu_is_one_truncated_product(n_bits, npl, signed):
    """What the kernel's product path computes, held against the plain
    version and the reference (``_jnp_path`` and the Pallas kernel in
    interpret mode), with and without row budgets and plane bounds that
    include 0.  Dyadic weights: every sum exact, so equal.  Normal weights:
    float32 sums in other orders, within rtol 1e-5 + 1e-5 * max|out|."""
    from repro.kernels import ops as jops

    rng = np.random.default_rng(100 + 10 * n_bits + npl)
    M, K, N, bn, bk = 32, 48, 48, 16, 16
    top = 2 ** n_bits
    aq = rng.integers(-(top - 1) if signed else 0, top, (M, K))
    aq = aq.astype(np.int16 if signed else np.int32)
    bound = np.asarray([n_bits, 0, 2], np.int32)
    # callers pass budgets no deeper than npl (execute: npl = budget.max())
    budget = np.minimum(rng.integers(0, n_bits + 1, M), npl).astype(np.int32)
    dyadic = (rng.integers(-64, 65, (K, N)) / 64).astype(np.float32)
    normal = rng.normal(0, 0.05, (K, N)).astype(np.float32)
    for w, exact in ((dyadic, True), (normal, False)):
        for bud, bnd in ((None, np.full(3, n_bits, np.int32)),
                         (budget, bound)):
            want, used = _truncated_product(aq.astype(np.int64), w, n_bits,
                                            n_bits, npl, bud, bnd, bn)
            kw = dict(n_bits=n_bits, relu=False, block_m=16, block_n=bn,
                      block_k=bk, n_planes_rt=npl)
            plain = tdm.dslot_matmul_plain(
                _t(aq), _t(w), row_budget=None if bud is None else _t(bud),
                plane_bound=_t(bnd), **kw)
            sfx, tot = jdm.colsum_tables(jnp.asarray(w), bk)
            jout, jused = jops._jnp_path(
                jnp.asarray(aq), jnp.asarray(w), n_bits, n_bits, False, 16,
                bn, bk, sfx, tot[0], jnp.asarray(npl, jnp.int32),
                jnp.full((M,), npl, jnp.int32) if bud is None
                else jnp.asarray(bud), jnp.asarray(bnd))
            outs = [_n(plain.out), np.asarray(jout)]
            useds = [_n(plain.planes_used), np.asarray(jused)]
            if bud is not None:
                pal = jdm.dslot_matmul_pallas(
                    jnp.asarray(aq), jnp.asarray(w),
                    row_budget=jnp.asarray(bud), plane_bound=jnp.asarray(bnd),
                    **kw)
                outs.append(np.asarray(pal.out))
                useds.append(np.asarray(pal.planes_used))
            for got, u in zip(outs, useds):
                np.testing.assert_array_equal(u, used)
                if exact:
                    np.testing.assert_array_equal(got, want.astype(np.float32))
                else:
                    tol = 1e-5 * np.abs(want) + 1e-5 * np.abs(want).max()
                    assert (np.abs(got - want) <= tol).all(), \
                        np.abs(got - want).max()
