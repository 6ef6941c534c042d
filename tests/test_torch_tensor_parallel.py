"""Port parity: tensor-parallel DSLOT serving (``repro_torch.launch.mesh``,
``models/pspec.py``, ``dslot_prepare(mesh=...)`` and the sharded execute,
``ServeConfig.mesh``) on ``torch.distributed`` with ``gloo`` on the CPU.

The contract is the reference's (``tests/test_tensor_parallel.py``): a
mesh-prepared ``dslot_execute``, and a whole ``ServeEngine`` on it, equal
the unsharded path bit for bit.  The reference cannot be the oracle for the
sharded path (its sharded execute with ``sort_columns=True`` raises), so
the port's sharded results are held against the port's unsharded ones bit
for bit and against the reference's ``mesh=None`` path (``backend="jnp"``)
within ``test_torch_ops``'s tolerances.

The spawned ranks (``torch_parallel_ranks.tp_world``, one world of 2 and
one of 4 ranks for the whole file) import only torch and ``repro_torch``
and run one thread each: a CPU BLAS on several threads may split a
product's K across threads by the product's width, and a shard's product
is narrower than the whole.  The one-rank properties run in an in-process
world.
"""

import datetime

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch_one_thread  # noqa: F401  (PyTorch on one CPU thread)
import torch.distributed as dist

import repro.serve as jserve
import torch_parallel_ranks as ranks
from _hyp import given, settings, st
from repro.kernels import ops as jops
from repro.models.model_zoo import build_model as jbuild
from repro_torch.convert import model_params
from repro_torch.kernels import ops as tops
from repro_torch.launch.mesh import (make_production_mesh, make_test_mesh,
                                     run_world)
from repro_torch.models import pspec
from repro_torch.models.model_zoo import build_model
from repro_torch.serve import Request, ServeConfig, ServeEngine

from test_torch_models import cfg_pair, ref_params
from test_torch_ops import _assert_same

DSLOT = dict(enabled=True, block_m=16, block_n=32, block_k=16,
             act_scale=0.05)
PROMPTS = ([3, 1, 4, 1, 5, 9, 2, 6], [2, 7, 1, 8, 2, 8],
           [1, 6, 1, 8, 0, 3, 3])
BUDGETS = (8, 5, 6)
KW = dict(n_bits=8, relu=True, block_m=16, block_n=16, block_k=16)
M, K, N = 20, 48, 80            # Nt = 5 tiles: neither 2 nor 4 divides it


# ------------------------------------------------------------ cases

def execute_cases() -> list[dict]:
    """The reference's shard sweep as a deterministic corner sweep: two
    seeds x MSR bound x sorted columns x scalar / per-row budget, an inert
    first tile (bound 0)."""
    cases = []
    for seed in (0, 1):
        for msr in (False, True):
            for sort in (False, True):
                for vector in (False, True):
                    rng = np.random.default_rng(seed)
                    w = rng.normal(size=(K, N)).astype(np.float32)
                    w[:, :16] = 0.0
                    x = rng.normal(size=(M, K)).astype(np.float32).clip(0)
                    npl = (rng.integers(1, 9, size=M).astype(np.int32)
                           if vector else int(rng.integers(1, 9)))
                    cases.append(dict(w=w, x=x, npl=npl, kw=dict(
                        KW, msr_bound=msr, sort_columns=sort)))
    return cases


def reference_execute(case):
    """The reference's ``mesh=None`` execute (its ``_jnp_path``)."""
    npl = case["npl"]
    prep = jops.dslot_prepare(jnp.asarray(case["w"]), backend="jnp",
                              **case["kw"])
    return jops.dslot_execute(prep, jnp.asarray(case["x"]), n_planes=npl
                              if not isinstance(npl, np.ndarray)
                              else jnp.asarray(npl))


def as_torch(res: dict):
    """A rank's numpy result as ``(out, DslotStats)``."""
    return torch.as_tensor(res["out"]), tops.DslotStats(
        planes_used=torch.as_tensor(res["planes_used"]),
        n_planes=res["n_planes"],
        skipped_frac=torch.tensor(res["skipped_frac"]),
        row_planes_used=torch.as_tensor(res["row_planes_used"]),
        planes_bounded=torch.as_tensor(res["planes_bounded"]))


def assert_bit_equal(a: dict, b: dict, what):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{what} {k}")
        else:
            assert a[k] == b[k], (what, k, a[k], b[k])


class Engines:
    """Reduced olmo-1b with a ReLU MLP on the DSLOT path (the reference's
    ``test_sharded_serve_engine_token_identical`` model), reference
    parameters carried over by ``convert.model_params``."""

    def __init__(self):
        self.jc, self.tc = cfg_pair("olmo-1b", dslot=DSLOT, act="relu",
                                    glu=False)
        self.p_np, _ = ref_params(self.jc, seed=0)

    def reference_burst(self):
        eng = jserve.ServeEngine(
            jbuild(self.jc), jax.tree.map(jnp.asarray, self.p_np),
            jserve.ServeConfig(n_slots=2, max_len=64, prefill_chunk=4))
        reqs = [jserve.Request(uid=i, prompt=np.asarray(p, np.int32),
                               max_new=6, n_planes=b)
                for i, (p, b) in enumerate(zip(PROMPTS, BUDGETS))]
        for r in reqs:
            assert eng.try_add(r)
        for _ in range(300):
            if all(r.done for r in reqs):
                break
            eng.step()
        return [(list(map(int, r.out)), r.result.planes_used_mean)
                for r in reqs]


@pytest.fixture(scope="module")
def engines():
    return Engines()


@pytest.fixture(scope="module")
def worlds(engines):
    """One spawned world per size, run on first use: every check's
    results, rank by rank."""
    cache = {}
    rng = np.random.default_rng(7)
    layers = [(rng.normal(size=(48, 80)).astype(np.float32),
               rng.normal(size=(20, 48)).astype(np.float32).clip(0)),
              (rng.normal(size=(3, 3, 4, 40)).astype(np.float32),
               rng.normal(size=(2, 6, 6, 4)).astype(np.float32).clip(0))]
    payload = (execute_cases(), layers, (engines.tc, engines.p_np, PROMPTS,
                                         BUDGETS))

    def get(n):
        if n not in cache:
            cache[n] = run_world(ranks.tp_world, n, backend="gloo",
                                 device="cpu", timeout=60, deadline=240,
                                 args=(n, *payload))
        return cache[n]
    return get


@pytest.fixture(scope="module")
def one_rank():
    """An in-process world of one rank (gloo, CPU) and its (1, 1) mesh."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        yield make_test_mesh(n_devices=1, model=1)
    finally:
        pspec.set_mesh(None)
        dist.destroy_process_group()


# ------------------------------------------------------------ meshes

def test_make_test_mesh_rejects_too_few_devices():
    # the reference's regression: n // model == 0 must raise, not build a
    # zero-extent (0, model) mesh
    with pytest.raises(ValueError, match="at least model=2"):
        make_test_mesh(n_devices=1, model=2)
    with pytest.raises(ValueError, match="at least model=4"):
        make_test_mesh(n_devices=2, model=4)
    with pytest.raises(ValueError):
        make_test_mesh(n_devices=4, model=0)
    with pytest.raises(ValueError, match="run_world"):    # a world of one
        make_test_mesh(model=2)
    with pytest.raises(ValueError, match="exceeds the world"):
        make_test_mesh(n_devices=2, model=1)
    with pytest.raises(ValueError, match="needs a world of 256"):
        make_production_mesh()


def test_prepare_rejects_missing_axis(one_rank):
    with pytest.raises(ValueError, match="tp_axis"):
        tops.dslot_prepare(torch.zeros((8, 8)), mesh=one_rank,
                           tp_axis="nope")


def test_pspec_sizes_one_rank_mesh(one_rank):
    assert ranks.pspec_sizes(one_rank) == (1, 1, ("kv",) * 4)
    assert dict(zip(one_rank.mesh_dim_names, one_rank.shape)) == {
        "data": 1, "model": 1}
    assert pspec.tp_size() == pspec.fsdp_size() == 1   # set_mesh(None)
    x = torch.ones(3)
    assert pspec.constrain(x, "b", "tp") is x


@pytest.mark.parametrize("n,meshes", [
    (2, {2: (2, 1, ("kv", "kv", "group", "repeat"))}),
    (4, {4: (4, 1, ("kv", "group", "group", "repeat")),
         2: (2, 2, ("kv", "kv", "group", "repeat"))})])
def test_pspec_sizes_on_spawned_meshes(worlds, n, meshes):
    """(1, 2), (1, 4) and (2, 2): tp_size, fsdp_size and head_scheme read
    the installed mesh as the reference's do."""
    for res in worlds(n):
        assert res["pspec"] == meshes, res["rank"]


@pytest.mark.parametrize("n", [2, 4])
def test_mesh_groups_carry_the_world_timeout(worlds, n):
    """Every axis group of the (1, n) and (2, 2) meshes fails after the
    world's 60 s, not the backend's 30-minute default."""
    for res in worlds(n):
        for shards, secs in res["timeouts"].items():
            assert secs == [60.0, 60.0], (res["rank"], shards, secs)


# ------------------------------------------------- one-rank property

def _rand_case(seed, m, k, n, zero_cols):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(k, n)).astype(np.float32)
    if zero_cols:
        w[:, : n // 4] = 0.0                      # inert tiles for the bound
    x = rng.normal(size=(m, k)).astype(np.float32).clip(0)
    return w, x


@settings(deadline=None)
@given(seed=st.integers(0, 2**31 - 1), msr=st.booleans(),
       sort=st.booleans(), zero_cols=st.booleans(),
       npl=st.one_of(st.integers(1, 8), st.just("rows")))
def test_one_shard_mesh_bit_identical(one_rank, seed, msr, sort, zero_cols,
                                      npl):
    """The reference's property on a one-rank mesh, ``sort_columns`` True
    included (the reference's sharded path raises there)."""
    m, k, n = 12, 32, 64
    w, x = _rand_case(seed, m, k, n, zero_cols)
    if npl == "rows":
        npl = np.random.default_rng(seed + 1).integers(1, 9, size=m) \
            .astype(np.int32)
    case = dict(w=w, x=x, npl=npl, kw=dict(
        n_bits=8, relu=True, sort_columns=sort, msr_bound=msr, block_m=8,
        block_n=16, block_k=16))
    res = ranks.execute_pair(case, one_rank)
    assert_bit_equal(res["sharded"], res["plain"], "one shard")
    _assert_same(reference_execute(case), as_torch(res["sharded"]))


# ------------------------------------------------- spawned worlds

@pytest.mark.parametrize("n", [2, 4])
def test_sharded_execute_bit_identical_to_unsharded(worlds, n):
    """Every case, every rank, every mesh of the world: the output and
    every ``DslotStats`` field equal the port's unsharded execute bit for
    bit, and a rank keeps about 1/shards of the prepared weight bytes."""
    for res in worlds(n):
        for shards, pairs in res["execute"].items():
            for i, pair in enumerate(pairs):
                assert_bit_equal(pair["sharded"], pair["plain"],
                                 (res["rank"], shards, i))
                # 5 tiles of 16 columns: 3 a rank at 2 shards, 2 at 4
                mine, whole = pair["bytes"]
                assert whole == K * N
                assert mine == K * 16 * -(-5 // shards), (shards, mine)


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_layers_bit_identical(worlds, n):
    """``DslotDense`` (sorted columns) and ``DslotConv2d`` (same padding)
    built with ``mesh=``: outputs and ``planes_used`` equal the unsharded
    layers' on every rank (80 and 40 output columns: 5 and 3 tiles)."""
    for res in worlds(n):
        for shards, flags in res["layers"].items():
            assert flags == [True, True], (res["rank"], shards)


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_execute_matches_reference(worlds, n):
    """Rank 0's sharded results against the reference's ``mesh=None``
    path: ``planes_used`` and ``planes_bounded`` equal, floats within the
    unsharded parity test's tolerances."""
    res = worlds(n)[0]
    for shards, pairs in res["execute"].items():
        for case, pair in zip(execute_cases(), pairs):
            _assert_same(reference_execute(case), as_torch(pair["sharded"]))


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_serve_engine_token_identical(worlds, engines, n):
    """The reference's end-to-end pin: a sharded ``ServeEngine`` burst
    (per-request budgets 8, 5, 6; chunked admission) emits on every rank
    the token streams of the reference engine (``mesh=None``) and of the
    port's unsharded engine, whose plane accounts it equals exactly."""
    ref = engines.reference_burst()
    for res in worlds(n):
        got, plain = res["engine"], res["engine_plain"]
        assert [t for t, _ in got] == [t for t, _ in ref], res["rank"]
        assert got == plain, res["rank"]
        for (_, pg), (_, pr) in zip(got, ref):
            assert abs(pg - pr) < 1e-6, (res["rank"], pg, pr)


def test_sharded_chaos_quarantine_isolation(worlds):
    """The reference's 2-shard chaos mirror: an injected NaN quarantines
    exactly the victim, the auditor stays empty every step, and the
    survivor's stream equals a sharded run that never admitted the
    victim."""
    for res in worlds(2):
        c = res["chaos"]
        assert c["victim_phase"] == c["quarantined_phase"]
        assert c["victim_done"] and c["quarantined"] == [2]
        assert c["survivor_phase"] == "done" and len(c["survivor"]) == 8
        assert c["survivor"] == c["alone"]
        assert c["audits"] == []


def test_engine_lets_a_failed_collective_through(engines):
    """``step()`` absorbs and retries other errors, but a failed collective
    means the ranks disagree: it propagates."""
    eng = ServeEngine(build_model(engines.tc),
                      model_params(engines.p_np, device="cpu"),
                      ServeConfig(n_slots=2, max_len=64, prefill_chunk=4))
    assert eng.try_add(Request(uid=0, prompt=np.asarray(PROMPTS[0],
                                                        np.int32), max_new=4))

    def broken(*args):
        raise dist.DistError("all_gather over mesh axis 'model' failed")

    eng._decode = broken
    with pytest.raises(dist.DistError):
        for _ in range(20):           # the first step that decodes raises
            eng.step()
    assert eng.errors == [] and eng.slot_req[0] is not None


def test_diverging_rank_fails_within_the_timeout():
    """A rank that posts a collective its peer never posts fails after the
    world's timeout with ``DistError``; the world reports it, no hang."""
    with pytest.raises(RuntimeError, match="rank 0 failed(.|\n)*DistError"):
        run_world(ranks.lone_gather, 2, backend="gloo", device="cpu",
                  timeout=3, deadline=60, args=(30,))
