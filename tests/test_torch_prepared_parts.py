"""W's bf16 parts, lowered once per layer by ``dslot_prepare``
(``repro_torch.kernels.dslot_matmul.split_parts`` and its plain version),
and the per-vote-tile semantics that the kernel's band path keeps.

On the CPU ``split_parts`` runs ``split_parts_plain``; the card-only tests
in ``test_torch_cuda.py`` hold the CUDA split and the band kernel against
these plain versions.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
import torch_one_thread  # noqa: F401  (PyTorch on one CPU thread)

from repro.kernels import ops as jops
from repro_torch.kernels import dslot_matmul as dm
from repro_torch.kernels import ops as tops
from repro_torch.launch.mesh import run_world

import torch_parallel_ranks as ranks


def _wide(seed, K, N):
    """f32 weights of random sign and magnitude 2^u, u uniform in [-20, 0]."""
    rng = np.random.default_rng(seed)
    mag = np.exp2(rng.uniform(-20.0, 0.0, (K, N)))
    return (np.where(rng.random((K, N)) < 0.5, -mag, mag)
            .astype(np.float32))


@pytest.mark.parametrize("block_n", [5, 8, 16, 32, 128])
def test_split_parts_sum_back_exactly(block_n):
    """hi + mid + lo == w in float64 for f32 weights of magnitudes 2^-20 to
    1 (24 bits of significand in three bf16 parts), each part in its tile's
    columns of the [part][K][N tile][PN] layout; where PN is block_n (16,
    32, 128) that layout is [part][K][N], as the band kernel maps it."""
    K, N = 24, 3 * block_n
    w = torch.as_tensor(_wide(0, K, N))
    parts = dm.split_parts_plain(w, block_n, 3)
    pn = -(-block_n // 8) * 8
    assert parts.shape == (3, K, 3, pn) and parts.dtype == torch.bfloat16
    total = parts.to(torch.float64).sum(dim=0)[:, :, :block_n]
    assert torch.equal(total.reshape(K, N), w.to(torch.float64))
    hi = parts[0, :, :, :block_n].reshape(K, N)
    assert torch.equal(hi, w.to(torch.bfloat16))
    if pn == block_n:
        assert torch.equal(parts.reshape(3, K, N)[0], hi)


@pytest.mark.parametrize("block_n", [5, 24])
def test_split_parts_pad_columns_are_zero(block_n):
    w = torch.as_tensor(_wide(1, 16, 2 * block_n))
    parts = dm.split_parts_plain(w, block_n, 3)
    assert parts.shape[-1] == -(-block_n // 8) * 8
    assert not parts[..., block_n:].any()


def test_part_count():
    """One part where bf16 holds every weight (a bf16 model's weights
    widened to f32, or bf16 weights), three otherwise; one part of such
    weights is bf16(w), whose mid and lo parts are zero."""
    w = torch.as_tensor(_wide(2, 32, 16))
    assert dm.part_count(w) == 3
    wb = w.to(torch.bfloat16)
    assert dm.part_count(wb) == 1 and dm.part_count(wb.float()) == 1
    three = dm.split_parts_plain(wb.float(), 8, 3)
    assert not three[1:].any()
    assert torch.equal(dm.split_parts(wb.float(), 8, 1), three[:1])


@pytest.mark.parametrize("relu,n_bits,block_n,wdtype,want", [
    (True, 8, 16, torch.float32, 3),
    (True, 8, 16, torch.bfloat16, 1),
    (True, 8, 128, "bf16-exact", 1),
    (True, 8, 8, torch.float32, 0),      # may stay resident: no parts
    (False, 8, 16, torch.float32, 0),    # the product path reads w itself
    (False, 26, 16, torch.float32, 3)])  # > 24 bits: the plane path
def test_prepare_stores_parts(relu, n_bits, block_n, wdtype, want,
                              monkeypatch):
    """On the CPU ``dslot_prepare`` stores no parts (the plain version never
    reads them).  On the card it stores ``split_parts`` of its padded
    weights for layers whose tiles stream W: the card's rule is run here
    with the CPU tensors standing in for the card's (``split_parts`` then
    runs its plain version), and execution gives the same result with and
    without the parts."""
    w = torch.as_tensor(_wide(3, 40, 48))
    w = w.to(torch.bfloat16).float() if wdtype == "bf16-exact" \
        else w.to(wdtype)
    kw = dict(n_bits=n_bits, relu=relu, block_m=16, block_n=block_n,
              block_k=16)
    assert tops.dslot_prepare(w, **kw).parts is None
    monkeypatch.setattr(tops, "_on_card", lambda t: True)
    prep = tops.dslot_prepare(w, **kw)
    if want == 0:
        assert prep.parts is None
        return
    assert torch.equal(prep.parts,
                       dm.split_parts_plain(prep.w, block_n, want))
    x = torch.as_tensor(np.random.default_rng(4).normal(
        0.3, 1.0, (20, 40)).astype(np.float32)).clamp_min(0)
    a = tops.dslot_execute(prep, x)
    b = tops.dslot_execute(
        tops.DslotWeights(**{**prep.__dict__, "parts": None}), x)
    assert torch.equal(a[0], b[0])
    assert torch.equal(a[1].planes_used, b[1].planes_used)


SHARD_KW = dict(n_bits=8, relu=True, signed=True, block_m=16, block_n=16,
                block_k=16, sort_columns=True)


def _shard_weights(wdtype):
    w = _wide(5, 40, 3 * 16 + 6)             # 4 tiles of 16, the last ragged
    if wdtype == "bf16-exact":
        w = torch.as_tensor(w).to(torch.bfloat16).float().numpy()
    return w


@pytest.fixture(scope="module")
def sharded_parts():
    """Each rank's prepared parts in one world of 2 over (1, 2), for f32
    weights and for weights bf16 holds."""
    cases = [(_shard_weights(d), SHARD_KW) for d in ("float32", "bf16-exact")]
    return run_world(ranks.prepared_parts_cases, 2, backend="gloo",
                     device="cpu", timeout=60, deadline=120, args=(cases,))


@pytest.mark.parametrize("case,wdtype", [(0, "float32"), (1, "bf16-exact")])
def test_sharded_parts_equal_parts_of_the_slice(sharded_parts, case, wdtype):
    """In a world of 2 over (1, 2), under the card's rule (the ranks' CPU
    tensors standing in for the card's), each rank's prepared parts are
    the parts of its own columns of the unsharded padded layout (the part
    count decided over the whole layer: 3 for f32, 1 where bf16 holds it);
    under the CPU's, a rank stores none."""
    w = _shard_weights(wdtype)
    whole = tops.dslot_prepare(torch.as_tensor(w), **SHARD_KW)
    n_parts = 3 if wdtype == "float32" else 1
    for res in sharded_parts:
        got = res["cases"][case]
        assert not got["stored_on_cpu"]
        lo, hi = got["cols"]
        want = dm.split_parts_plain(whole.w[:, lo:hi], 16, n_parts)
        assert got["parts"].shape == tuple(want.shape)
        np.testing.assert_array_equal(got["parts"], want.float().numpy())


@pytest.mark.parametrize("precision", ["full", "rows"])
def test_mixed_vote_tiles_match_reference(precision, monkeypatch):
    """Vote tiles of one N tile terminating at different planes: ``out``,
    per-tile ``planes_used`` and ``row_planes_used`` of the port (the
    kernel's plain version, with the parts the card's rule prepares) equal
    the reference's Pallas kernel (interpret mode) and its ``_jnp_path``."""
    monkeypatch.setattr(tops, "_on_card", lambda t: True)
    x, w = ranks.mixed_vote_case()
    kw = dict(n_bits=8, relu=True, signed=True, block_m=16, block_n=128,
              block_k=64)
    npl = None if precision == "full" else \
        np.random.default_rng(12).integers(3, 9, x.shape[0]).astype(np.int32)
    tp = tops.dslot_prepare(torch.as_tensor(w), **kw)
    assert tp.parts is not None and tp.parts.shape[0] == 3
    ty, ts = tops.dslot_execute(tp, torch.as_tensor(x), n_planes=None
                                if npl is None else torch.as_tensor(npl))
    used = ts.planes_used[:, 0].tolist()
    assert len(set(used)) >= 3, f"vote tiles must stop at different planes: {used}"
    for backend in ("pallas", "jnp"):
        jp = jops.dslot_prepare(jnp.asarray(w), backend=backend, **kw)
        jy, js = jops.dslot_execute(jp, jnp.asarray(x), n_planes=npl)
        np.testing.assert_array_equal(ts.planes_used.numpy(),
                                      np.asarray(js.planes_used),
                                      err_msg=backend)
        np.testing.assert_array_equal(ts.row_planes_used.numpy(),
                                      np.asarray(js.row_planes_used),
                                      err_msg=backend)
        # 64-term sums of 8 planes in another order, times the step
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                                   atol=1e-5, err_msg=backend)
