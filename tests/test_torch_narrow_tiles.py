"""The narrow vote tiles of the port's launchers (``block_n`` 16, 32 and
64, ``block_k`` 16 or whole sub-chunks), which the kernel's band path takes
with one vote per (row tile, column tile) and one plane bound per column
tile: the port's ``dslot_execute`` (the kernel's plain version, with the
parts the card's rule prepares) against the reference's Pallas kernel
(interpret mode) and its ``_jnp_path``.

The card-only tests in ``test_torch_cuda.py`` hold the kernel against the
same plain version.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
import torch_one_thread  # noqa: F401  (PyTorch on one CPU thread)

from repro.kernels import ops as jops
from repro_torch.kernels import ops as tops

# (block_m, block_n, block_k): the launchers' 32 x 32 (``launch/serve.py
# --dslot``), 16 x 16 (``launch/serve_lm.py``'s DSLOT generation), 16 x 32
# at block_k 16 (its SLO engine), and 16 x 64
TILES = [(32, 32, None), (16, 16, None), (16, 32, 16), (16, 64, None)]


def narrow_case(block_m, block_n):
    """(x, w) whose vote tiles stop at different planes along N.

    Row tiles of ``block_m`` rows alternate the sign of x (the second
    positive one at 0.3 of the first's magnitude); column tiles of
    ``block_n`` columns alternate mostly positive and mostly negative
    weights, the negative ones at magnitudes 1, 0.12, 0.5, 0.25 in turn,
    so that the tiles of one row die at different planes (and chunks),
    some never.  Column tile 1 is all zero: its weight-side plane bound is
    0 where its neighbours' is 8."""
    rng = np.random.default_rng(27)
    M, K, N = 4 * block_m, 128, 256
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
@pytest.mark.parametrize("block_m,block_n,block_k", TILES)
def test_narrow_vote_tiles_match_reference(block_m, block_n, block_k,
                                           precision, monkeypatch):
    """Per-(row tile, column tile) votes and per-column-tile plane bounds:
    ``planes_used`` and ``row_planes_used`` equal the reference's through
    Pallas (interpret mode) and ``_jnp_path``; ``out`` within 1e-5."""
    monkeypatch.setattr(tops, "_on_card", lambda t: True)
    x, w = narrow_case(block_m, block_n)
    kw = dict(n_bits=8, relu=True, signed=True, block_m=block_m,
              block_n=block_n, block_k=block_k)
    npl = None if precision == "full" else \
        np.random.default_rng(28).integers(3, 9, x.shape[0]).astype(np.int32)
    tp = tops.dslot_prepare(torch.as_tensor(w), **kw)
    assert tp.parts is not None and tp.parts.shape[-1] == block_n
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
        np.testing.assert_array_equal(ts.row_planes_used.numpy(),
                                      np.asarray(js.row_planes_used),
                                      err_msg=backend)
        # 128-term sums of 8 planes in another order, times the step
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                                   atol=1e-5, err_msg=backend)
