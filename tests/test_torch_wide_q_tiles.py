"""The 512 x 32 vote tiles of 20-bit signed q (int32 storage), whose (4, 4)
warp tiles overflow three ring stages of one block and which the kernel
spreads over a thread-block cluster: the port's plain version (CPU
tensors) against the reference's Pallas kernel in interpret mode at the
same geometry (``block_k`` 128), on dyadic weights and per-row budgets of
1-8 planes, where every sum is exact.

The port's ``out`` equals the exact sums (float64) bit for bit.  The
reference's does not quite: XLA's ``exp2`` on the CPU is not exact at odd
integers from 13 up (``exp2(19.0)`` is 2^19 - 0.21875), so its plane
scales 2^(n_bits-1-d) for ``n_bits`` 20 are off by up to 4.2e-7 of
themselves; its ``out`` is held within 1e-6 of the largest |out|, and its
``planes_used`` exactly.

The card-only tests in ``test_torch_cuda.py`` (``-k "cluster or wide_q"``)
hold the kernel against the same plain version.
"""

import importlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch
import torch_one_thread  # noqa: F401  (PyTorch on one CPU thread)

from repro_torch.kernels import dslot_matmul as tdm

# the reference package's ``kernels`` exports a function of the same name
jdm = importlib.import_module("repro.kernels.dslot_matmul")

BLOCK_M, BLOCK_N, BLOCK_K, N_BITS = 512, 32, 128, 20


def wide_case(M, seed):
    """(q, w): row tiles of alternating sign (q of 20 bits, at least 2^18
    in magnitude, so that the top planes carry digits) and column tiles of
    alternating sign (multiples of 2^-6 within 1/64 to 1), so that a tile
    of positive q by negative weights stops after its first planes and
    the others run to their budgets."""
    rng = np.random.default_rng(seed)
    K, N = 256, 64
    rt = np.arange(M) // BLOCK_M
    q = rng.integers(2 ** 18, 2 ** (N_BITS - 1), (M, K))
    q = q * np.where(rt % 2 == 0, 1, -1)[:, None]
    ct = np.arange(N) // BLOCK_N
    w = rng.integers(1, 65, (K, N)) / 64.0
    w = w * np.where(ct % 2 == 0, -1.0, 1.0)[None, :]
    return q.astype(np.int32), w.astype(np.float32)


def exact_out(q, w, budget, npl):
    """relu of the planes' sums in float64, each row to min(budget, npl)
    planes: the function every path computes, exactly.  A tile that stops
    early is provably negative at the end, so its relu is 0 here too."""
    mag, sign = np.abs(q.astype(np.int64)), np.sign(q)
    acc = np.zeros((q.shape[0], w.shape[1]))
    for d in range(npl):
        bit = (mag >> (N_BITS - 1 - d)) & 1
        live = (budget > d)[:, None]
        acc += 2.0 ** (N_BITS - 1 - d) * ((bit * sign * live)
                                          @ w.astype(np.float64))
    return np.maximum(acc, 0.0)


@pytest.mark.parametrize("M,budget", [(1024, "rows"), (512, "rows"),
                                      (1024, "runtime")])
def test_wide_q_tiles_match_reference_exactly(M, budget):
    """``planes_used`` equal to the reference's and ``out`` equal to the
    exact sums (digits of 20 bits, at most 8 planes of 128-term sums of
    dyadic weights: exact in f32), the reference's ``out`` within its
    scales' rounding; at least one tile stops before its last plane."""
    q, w = wide_case(M, seed=29 + M)
    rng = np.random.default_rng(30)
    if budget == "rows":
        # plane 0 (bit 19) holds no digit of signed 20-bit q, so a row at
        # budget 1 sums to 0 and its tile can never be proven negative:
        # the first row tile's budgets start at 2
        bud = rng.integers(1, 9, M).astype(np.int32)
        bud[:BLOCK_M] = rng.integers(2, 9, BLOCK_M)
        npl = int(bud.max())
    else:
        bud, npl = None, 6
    kw = dict(n_bits=N_BITS, n_planes=8, relu=True, block_m=BLOCK_M,
              block_n=BLOCK_N, block_k=BLOCK_K)
    assert tdm.q_storage_dtype(N_BITS, signed=True) == torch.int32
    t = tdm.dslot_matmul_cuda(
        torch.as_tensor(q), torch.as_tensor(w), n_planes_rt=npl,
        row_budget=None if bud is None else torch.as_tensor(bud), **kw)
    j = jdm.dslot_matmul_pallas(
        jnp.asarray(q), jnp.asarray(w), n_planes_rt=jnp.int32(npl),
        row_budget=None if bud is None else jnp.asarray(bud),
        interpret=True, **kw)
    used = t.planes_used.numpy()
    np.testing.assert_array_equal(used, np.asarray(j.planes_used))
    assert used.shape == (M // BLOCK_M, 2)
    assert (used < npl).any(), used
    out = t.out.numpy()
    want = exact_out(q, w, np.full(M, npl) if bud is None else bud, npl)
    np.testing.assert_array_equal(out, want.astype(np.float32))
    assert (out > 0).any()
    # the reference's scales: 4.2e-7 of themselves at most, over 8 planes
    np.testing.assert_allclose(np.asarray(j.out), out, rtol=0,
                               atol=1e-6 * np.abs(out).max())
