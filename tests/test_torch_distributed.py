"""Port parity: expert-parallel MoE (``repro_torch.distributed.
expert_parallel``), the dispatch groups of ``models.moe.apply_moe`` and the
collective matmul (``repro_torch.distributed.overlap``) on
``torch.distributed`` with ``gloo`` on the CPU.

The reference's own cases (``tests/test_distributed.py``) hold expert
parallelism against the dense ``apply_moe`` and the collective matmul
against ``x @ w``; so do these, with the reference's dense ``apply_moe``
run in this process.  Where the reference's expert-parallel capacity rule
differs from its dense one, the port is held against the reference's
``apply_moe_ep`` on a one-device mesh.  The spawned ranks (``torch_parallel_ranks.ep_world``,
one world of 2 and one of 4 ranks for the file) import only torch and
``repro_torch``.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch_one_thread  # noqa: F401  (PyTorch on one CPU thread)
from jax.sharding import Mesh

import repro.models.pspec as jpspec
import torch_parallel_ranks as ranks
from repro.distributed import expert_parallel as jep
from repro.models import moe as jmoe
from repro_torch.distributed import expert_parallel as tep
from repro_torch.launch.mesh import run_world

from test_torch_models import cfg_pair, close, rng_normal, to_np

LO = np.asarray([3, 8, 4, 8, 3, 8, 4, 8], np.int32)
EP_Y_ATOL, EP_AUX_ATOL = 2e-3, 1e-3     # the reference test's bounds
MATMUL_REL = 1e-5                       # of the largest |y|


class Cases:
    """The inputs of every check, from numpy seeds, and the reference's
    dense results."""

    def __init__(self):
        # the reference's EP case: reduced granite-moe with 8 experts, top-2
        self.jc, self.tc = cfg_pair("granite-moe-1b-a400m", n_experts=8,
                                    top_k=2)
        self.p = to_np(jmoe.init_moe(self.jc, jax.random.PRNGKey(0)))
        self.x = rng_normal(1, (2, 8, self.tc.d_model), 0.5)
        self.y, self.aux = jmoe.apply_moe(
            jax.tree.map(jnp.asarray, self.p), jnp.asarray(self.x), self.jc)
        # dispatch groups: 1024 tokens at capacity factor 0.25 drop choices,
        # and which ones depends on the group count
        self.gjc, self.gtc = cfg_pair("granite-moe-1b-a400m",
                                      capacity_factor=0.25)
        self.gp = to_np(jmoe.init_moe(self.gjc, jax.random.PRNGKey(2)))
        self.gx = rng_normal(3, (4, 256, self.gtc.d_model), 0.5)
        self.g1 = self.ref_groups(1)
        self.g2 = self.ref_groups(2)
        # where the reference's apply_moe_ep and apply_moe set different
        # capacities: a decode step of 1024 tokens (one capacity against
        # dropless) and a prefill of 2 x 4096 tokens (one capacity against
        # one for each 4096-token block)
        self.capacity_x = {"decode": rng_normal(5, (1024, 1, 64), 0.5),
                           "long prefill": rng_normal(6, (2, 4096, 64), 0.5)}
        mesh11 = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                      ("data", "model"))
        gp = jax.tree.map(jnp.asarray, self.gp)
        self.capacity_ref = {
            k: (jep.apply_moe_ep(gp, jnp.asarray(x), self.gjc, mesh11),
                jmoe.apply_moe(gp, jnp.asarray(x), self.gjc))
            for k, x in self.capacity_x.items()}
        # the reference's collective-matmul shapes
        rng = np.random.default_rng(0)
        self.X = rng.normal(0, 1, (64, 32)).astype(np.float32)
        self.W = rng.normal(0, 1, (32, 48)).astype(np.float32)

    def ref_groups(self, g):
        """The reference's ``apply_moe`` with ``fsdp_size`` patched to
        ``g`` (dispatch per data shard); no reference file changes."""
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jpspec, "fsdp_size", lambda: g)
            return jmoe.apply_moe(jax.tree.map(jnp.asarray, self.gp),
                                  jnp.asarray(self.gx), self.gjc)

    def payload(self, n):
        return (n, (self.tc, self.p, self.x, LO), (self.X, self.W),
                (self.gtc, self.gp, self.gx, self.capacity_x))


@pytest.fixture(scope="module")
def cases():
    return Cases()


@pytest.fixture(scope="module")
def worlds(cases):
    cache = {}

    def get(n):
        if n not in cache:
            cache[n] = run_world(ranks.ep_world, n, backend="gloo",
                                 device="cpu", timeout=60, deadline=240,
                                 args=cases.payload(n))
        return cache[n]
    return get


# ------------------------------------------------------------ in process

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_truncate_planes_matches_reference(dtype):
    """Per-expert digit-plane truncation, exactly the reference's: budgets
    from 0 planes to past ``n_bits``, full budgets untouched."""
    x = rng_normal(4, (6, 5, 7), 0.8)
    planes = np.asarray([0, 1, 3, 7, 8, 12], np.int32)
    ref = jep._truncate_planes(jnp.asarray(x).astype(dtype),
                               jnp.asarray(planes), 8)
    got = tep._truncate_planes(torch.as_tensor(x).to(getattr(torch, dtype)),
                               torch.as_tensor(planes), 8)
    assert str(got.dtype).endswith(dtype)
    np.testing.assert_array_equal(got.to(torch.float32).numpy(),
                                  np.asarray(ref, np.float32))
    np.testing.assert_array_equal(got[4:].to(torch.float32).numpy(),
                                  np.asarray(jnp.asarray(x[4:])
                                             .astype(dtype), np.float32))


def test_moe_dispatch_groups_change_the_drops(cases):
    """The reference's G = 2 differs from its G = 1 on this case, so the
    group test below checks the dispatch groups, not a no-op."""
    assert not np.allclose(np.asarray(cases.g1[0]), np.asarray(cases.g2[0]))


# ------------------------------------------------------------ spawned

@pytest.mark.parametrize("n", [2, 4])
def test_expert_parallel_matches_dense_reference(worlds, cases, n):
    """EP over (1, n) against the reference's dense ``apply_moe`` within
    the reference test's bounds, the same on every rank."""
    res = worlds(n)
    for r in res:
        np.testing.assert_allclose(r["y"], np.asarray(cases.y),
                                   atol=EP_Y_ATOL, rtol=0)
        assert abs(r["aux"] - float(cases.aux)) < EP_AUX_ATOL
        np.testing.assert_array_equal(r["y"], res[0]["y"])


@pytest.mark.parametrize("case", ["decode", "long prefill"])
@pytest.mark.parametrize("n", [2, 4])
def test_expert_parallel_follows_reference_ep_capacity(worlds, cases, n,
                                                       case):
    """Where the reference's ``apply_moe_ep`` and ``apply_moe`` set
    different capacities, the port's EP follows ``apply_moe_ep`` (run here
    on a one-device mesh) within the reference test's bounds, and differs
    from the dense ``apply_moe`` by more than them."""
    (y_ep, aux_ep), (y_dense, _) = cases.capacity_ref[case]
    for r in worlds(n):
        y, aux = r["capacity"][case]
        np.testing.assert_allclose(y, np.asarray(y_ep), atol=EP_Y_ATOL,
                                   rtol=0)
        assert abs(aux - float(aux_ep)) < EP_AUX_ATOL
        assert np.abs(y - np.asarray(y_dense)).max() > EP_Y_ATOL


@pytest.mark.parametrize("n", [2, 4])
def test_expert_parallel_full_budgets_are_exact_noops(worlds, n):
    for r in worlds(n):
        np.testing.assert_array_equal(r["y_full"], r["y"])


@pytest.mark.parametrize("n", [2, 4])
def test_expert_parallel_truncated_budgets(worlds, cases, n):
    """Truncated budgets: deterministic, finite, different from full
    precision, and within quantization distance of the dense forward."""
    for r in worlds(n):
        assert np.isfinite(r["y_lo"]).all()
        np.testing.assert_array_equal(r["y_lo"], r["y_lo2"])
        assert not np.array_equal(r["y_lo"], r["y"])
        np.testing.assert_allclose(r["y_lo"], np.asarray(cases.y),
                                   atol=0.25, rtol=0)


@pytest.mark.parametrize("n", [2, 4])
def test_collective_matmul_matches_product(worlds, cases, n):
    """The ring and the all-gather lowering against ``x @ w``: each rank
    holds every row of its own columns."""
    want = cases.X.astype(np.float64) @ cases.W.astype(np.float64)
    cols = cases.W.shape[1] // n
    for r in worlds(n):
        j, ring, plain = r["cm"]
        ref = want[:, j * cols:(j + 1) * cols]
        tol = MATMUL_REL * np.abs(want).max()
        np.testing.assert_allclose(ring, ref, atol=tol, rtol=0)
        np.testing.assert_allclose(plain, ref, atol=tol, rtol=0)


def test_moe_dispatch_groups_match_reference(worlds, cases):
    """``apply_moe`` with the (2, 2) mesh installed dispatches per data
    shard (G = 2): the reference's semantics with ``fsdp_size`` 2."""
    for r in worlds(4):
        g = r["groups"]
        close(torch.as_tensor(g["y"]), cases.g2[0])
        close(torch.as_tensor(g["aux"]), cases.g2[1])


def test_expert_parallel_over_a_data_axis(worlds, cases):
    """EP over the (2, 2) mesh's model axis, each data rank on its half of
    the batch: its rows of the reference's G = 2 dispatch, and the aux of
    the whole batch."""
    ref = np.asarray(cases.g2[0])
    for r in worlds(4):
        g = r["groups"]
        half = ref.shape[0] // 2
        close(torch.as_tensor(g["y_ep"]),
              ref[g["data"] * half:(g["data"] + 1) * half])
        close(torch.as_tensor(g["aux_ep"]), cases.g2[1])
