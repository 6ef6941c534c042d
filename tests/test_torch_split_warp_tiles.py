"""The vote tiles of 24, 40, 48 and 56 columns (seamless-m4t-medium's MLP up
at ``block_n`` 24, which the tensor-parallel execute shards), which the
kernel's band path takes with blocks of the whole column tiles that fit in
128 columns, each 8-column half of a warp voting for its own column tile:
the port's ``dslot_execute`` (the kernel's plain version, with the parts
the card's rule prepares) against the reference's Pallas kernel
(interpret mode) and its ``_jnp_path``.

The card-only tests in ``test_torch_cuda.py`` (``-k split_warp``) hold the
kernel against the same plain version.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
import torch_one_thread  # noqa: F401  (PyTorch on one CPU thread)

from repro.kernels import ops as jops
from repro_torch.kernels import ops as tops

# (block_m, block_n): each width at block_m 32 and at one other
TILES = [(32, 24), (128, 24), (32, 40), (16, 40), (32, 48), (64, 48),
         (32, 56), (16, 56)]


def split_case(block_m, block_n):
    """(x, w) whose vote tiles stop at different planes along N.

    N holds at least five column tiles and one more than the blocks of
    whole column tiles that fit in 128 columns, so that the last block is
    partial.  Row tiles of ``block_m`` rows alternate the sign of x (the
    second positive one at 0.3 of the first's magnitude); column tiles
    alternate mostly positive and mostly negative weights, the negative
    ones at magnitudes 1, 0.12, 0.5, 0.25 in turn, so that the tiles of
    one row die at different planes, some never.  Column tile 1 is all
    zero: its weight-side plane bound is 0 where its neighbours' is 8."""
    rng = np.random.default_rng(28)
    M, K = 4 * block_m, 128
    N = block_n * max(5, 128 // block_n + 2)
    ct = np.arange(N) // block_n
    mag = np.array([1.0, 0.12, 0.5, 0.25])[(ct // 2) % 4]
    w = rng.normal(0.0, 0.01, (K, N)) + np.where(ct % 2 == 1, 0.02,
                                                 -0.02 * mag)
    w[:, ct == 1] = 0.0
    rt = np.arange(M) // block_m
    sign = np.where(rt % 2 == 0, 1.0, -1.0)[:, None]
    scale = np.where(rt == 2, 0.3, 1.0)[:, None]
    x = sign * scale * rng.uniform(0.5, 1.0, (M, K))
    return x.astype(np.float32), w.astype(np.float32)


@pytest.mark.parametrize("precision", ["full", "rows"])
@pytest.mark.parametrize("block_m,block_n", TILES)
def test_split_warp_vote_tiles_match_reference(block_m, block_n, precision,
                                               monkeypatch):
    """Per-(row tile, column tile) votes and per-column-tile plane bounds
    at column tiles that a warp's 16 columns may straddle:
    ``planes_used`` equal to the reference's through Pallas (interpret
    mode) and ``_jnp_path``, ``row_planes_used`` within one ulp, ``out``
    within 1e-5."""
    monkeypatch.setattr(tops, "_on_card", lambda t: True)
    x, w = split_case(block_m, block_n)
    kw = dict(n_bits=8, relu=True, signed=True, block_m=block_m,
              block_n=block_n)
    npl = None if precision == "full" else \
        np.random.default_rng(29).integers(3, 9, x.shape[0]).astype(np.int32)
    tp = tops.dslot_prepare(torch.as_tensor(w), **kw)
    assert tp.parts is not None and tp.parts.shape[-1] == block_n
    assert tp.block_k % 64 == 0          # chunks of whole sub-chunks
    bound = tp.msr_bound.tolist()
    assert bound[0] == 8 and bound[1] == 0 and bound[2] == 8
    ty, ts = tops.dslot_execute(tp, torch.as_tensor(x), n_planes=None
                                if npl is None else torch.as_tensor(npl))
    used = ts.planes_used[0].tolist()
    assert len(set(used)) >= 3, \
        f"column tiles must stop at different planes: {used}"
    for backend in ("pallas", "jnp"):
        jp = jops.dslot_prepare(jnp.asarray(w), backend=backend, **kw)
        jy, js = jops.dslot_execute(jp, jnp.asarray(x), n_planes=npl)
        np.testing.assert_array_equal(ts.planes_used.numpy(),
                                      np.asarray(js.planes_used),
                                      err_msg=backend)
        # row_planes_used: means of small integers over 5 or 7 N tiles.
        # XLA's CPU mean rounds 38/7 to 5.4285717 where torch's division
        # gives the correctly rounded 5.428571: one ulp apart at most
        np.testing.assert_allclose(ts.row_planes_used.numpy(),
                                   np.asarray(js.row_planes_used),
                                   rtol=2.5e-7, atol=0, err_msg=backend)
        # 128-term sums of 8 planes in another order, times the step
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                                   atol=1e-5, err_msg=backend)
