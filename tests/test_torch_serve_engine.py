"""Port parity for the slot-pool serving engine (``repro_torch.serve``)
against the JAX reference (``repro.serve``), on reduced f32 olmo-1b configs.

The same requests (numpy prompts from seeds) go through both engines with
the same parameters (reference init, carried over by
``repro_torch.convert``).  Token streams, ``token_steps``, ``ttft_steps``,
phases and per-step budgets must be equal; the per-request plane
statistics equal within 1e-6 (means of f32 per-row values, summed in
another order).  The reference's DSLOT MLP runs its jnp replay, the port's
the kernel's plain version on CPU tensors.  The scenarios are the
reference's own engine tests: staggered admission
(``test_tools_serve.py``), per-request precision and SLO overload
(``test_tools_serve.py``, ``test_slo.py``) and ragged chunked admission
(``test_serve_prefill.py``).
"""

import dataclasses
import warnings

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import repro.serve as jserve
import repro_torch.serve as tserve
from repro.models.model_zoo import build_model as jbuild
from repro_torch.models.model_zoo import build_model as tbuild
from repro_torch.serve import engine as tengine

from test_torch_models import cfg_pair, ref_params

STAT_ATOL = 1e-6


class Pair:
    """One reduced config in both packages, with one set of weights."""

    def __init__(self, dslot=None, seed=3):
        self.jc, self.tc = cfg_pair("olmo-1b", dslot=dslot, act="relu",
                                    glu=False) if dslot else \
            cfg_pair("olmo-1b")
        p, tp = ref_params(self.jc, seed=seed)
        self.jm, self.tm = jbuild(self.jc), tbuild(self.tc)
        self.jp, self.tp = jax.tree.map(jnp.asarray, p), tp

    def engines(self, **cfg):
        slo = cfg.pop("slo", None)
        jcfg = jserve.ServeConfig(slo=None if slo is None
                                  else jserve.SloConfig(**slo), **cfg)
        tcfg = tserve.ServeConfig(slo=None if slo is None
                                  else tserve.SloConfig(**slo), **cfg)
        return (jserve.ServeEngine(self.jm, self.jp, jcfg),
                tserve.ServeEngine(self.tm, self.tp, tcfg))

    def solo(self, prompt, max_new, n_planes=None):
        """The port's solo ``generate`` of one prompt."""
        params = self.tm.prepare_dslot(self.tp)
        res = tserve.generate(self.tm, params,
                              {"tokens": torch.as_tensor(prompt[None])},
                              max_new, n_planes=n_planes)
        return res.tokens[0].tolist()


@pytest.fixture(scope="module")
def dense():
    return Pair()


@pytest.fixture(scope="module")
def dslot_uncalibrated():
    """The reference's per-request-precision model (test_tools_serve)."""
    return Pair(dslot=dict(enabled=True, block_m=16, block_n=32,
                           block_k=16), seed=4)


@pytest.fixture(scope="module")
def dslot_calibrated():
    """The reference's SLO model (test_slo): a pinned act_scale."""
    return Pair(dslot=dict(enabled=True, block_m=16, block_n=32, block_k=16,
                           act_scale=0.05), seed=11)


def prompt(n, seed=0):
    return np.random.RandomState(seed).randint(0, 256, size=n).astype(
        np.int32)


def requests(mod, specs):
    return [mod.Request(uid=s["uid"], prompt=prompt(s["n"], s["seed"]),
                        max_new=s.get("max_new", 3),
                        n_planes=s.get("n_planes"),
                        tier=s.get("tier", "standard"),
                        deadline_steps=s.get("deadline_steps"))
            for s in specs]


def snapshot(eng):
    return dict(
        budget=None if eng.last_budget is None
        else [int(v) for v in eng.last_budget],
        levels=None if eng.slo is None else dict(eng.slo.levels),
        slots=[None if r is None else r.uid for r in eng.slot_req],
        phases=eng.slot_phases(), depth=eng.queue_depth)


def drive(eng, reqs, arrivals, audit=None, max_steps=200):
    """Enqueue ``reqs[i]`` before step ``arrivals[i]`` and step until every
    request is terminal; returns the per-step snapshots."""
    order = sorted(range(len(reqs)), key=lambda i: arrivals[i])
    trace = []
    for step in range(max_steps):
        while order and arrivals[order[0]] <= step:
            assert eng.try_add(reqs[order.pop(0)])
        if not order and all(r.done for r in reqs):
            return trace
        eng.step()
        if audit is not None:
            audit(eng)
        trace.append(snapshot(eng))
    raise AssertionError(f"not terminal in {max_steps} steps")


def same_requests(treqs, jreqs):
    for t, j in zip(treqs, jreqs):
        assert t.out == j.out, t.uid
        assert (t.token_steps, t.ttft_steps, t.phase, t.enqueue_step) == \
            (j.token_steps, j.ttft_steps, j.phase, j.enqueue_step), t.uid
        if j.result is None:
            assert t.result is None
            continue
        assert (t.result.tokens, t.result.phase, t.result.steps,
                t.result.ttft_steps, t.result.uid, t.result.tier) == \
            (j.result.tokens, j.result.phase, j.result.steps,
             j.result.ttft_steps, j.result.uid, j.result.tier), t.uid
        assert t.result.n_planes == j.result.n_planes, t.uid
        for key in ("planes_used_mean", "skipped_frac",
                    "planes_bounded_mean"):
            a, b = getattr(t.result, key), getattr(j.result, key)
            assert (a is None) == (b is None), (t.uid, key)
            if a is not None:
                assert abs(float(a) - float(b)) <= STAT_ATOL, (t.uid, key)


def run_pair(pair, specs, arrivals, **cfg):
    jeng, teng = pair.engines(**cfg)
    jreqs, treqs = requests(jserve, specs), requests(tserve, specs)
    jtrace = drive(jeng, jreqs, arrivals)
    ttrace = drive(teng, treqs, arrivals, audit=tserve.check_invariants)
    assert ttrace == jtrace
    same_requests(treqs, jreqs)
    return jeng, teng, jreqs, treqs


# ------------------------------------------------------------- scenarios

def test_staggered_admissions_match_reference_and_solo(dense):
    """A request admitted into a non-empty pool disturbs no other slot:
    streams equal the reference engine's and the port's solo generate."""
    specs = [dict(uid=i, n=n, seed=10 + i, max_new=5)
             for i, n in enumerate((3, 4, 2))]
    _, _, _, treqs = run_pair(dense, specs, (0, 1, 3), n_slots=3,
                              max_len=32)
    for r in treqs:
        assert r.phase == tserve.DONE
        assert r.out == dense.solo(r.prompt, 5), r.uid


def test_dslot_per_request_precision_matches_reference(dslot_uncalibrated):
    """Per-request digit-plane budgets in one pooled step: the budget
    vector of every step, the streams and each request's plane account."""
    specs = [dict(uid=1, n=3, seed=1, n_planes=8),
             dict(uid=2, n=3, seed=2, n_planes=3),
             dict(uid=3, n=3, seed=3, n_planes=5)]
    jeng, teng, _, treqs = run_pair(dslot_uncalibrated, specs, (0, 0, 2),
                                    n_slots=2, max_len=32)
    assert teng.dslot and not teng.calibrated
    assert jeng.calibrated == teng.calibrated
    for r in treqs:
        assert r.dslot_stats["n_planes"] == r.n_planes
        assert 0 < r.dslot_stats["planes_used_mean"] <= r.n_planes
    assert treqs[1].dslot_stats["planes_used_mean"] <= 3.0


def test_slo_overload_sheds_and_restores_like_reference(dslot_calibrated):
    """The reference's overload case: a burst of 6 requests on 2 slots
    sheds degradable planes, holds reserved at n_bits, then restores every
    tier under slack — levels, budgets and events equal at every step."""
    specs = [dict(uid=i, n=6, seed=i, max_new=4,
                  tier="reserved" if i == 0 else "degradable")
             for i in range(6)]
    slo = dict(queue_high_water=1, shed_patience=1, restore_patience=2,
               target_ttft_steps=100)
    jeng, teng, jreqs, treqs = run_pair(
        dslot_calibrated, specs, (0,) * 6, n_slots=2, max_len=64,
        prefill_chunk=4, slo=slo)
    n_bits = teng.n_bits
    for _ in range(4 * n_bits):
        jeng.step()
        teng.step()
        assert teng.slo.levels == jeng.slo.levels
    for attr in ("shed_events", "restore_events", "min_levels", "levels",
                 "planes_used_ema"):
        assert getattr(teng.slo, attr) == getattr(jeng.slo, attr), attr
    assert teng.slo.summary() == jeng.slo.summary()
    assert teng.slo.shed_events > 0 and teng.slo.restore_events > 0
    assert teng.slo.min_levels["degradable"] < n_bits
    assert teng.slo.levels == {n: t.ceiling
                               for n, t in teng.slo.tiers.items()}
    assert treqs[0].result.n_planes == n_bits


RAGGED = [((9, 5, 13), 4, 2, (0, 0, 2)),
          ((6, 11), 4, 2, (0, 3)),
          ((13, 13, 13), 4, 2, (0, 0, 0)),
          ((12, 3, 7, 5), 5, 3, (0, 0, 0, 1))]


@pytest.mark.parametrize("lens,chunk,cps,arrivals", RAGGED)
def test_chunked_admission_matches_reference_and_whole_prompt(
        dense, lens, chunk, cps, arrivals):
    """Ragged prompts through the lane pool at staggered arrivals: streams
    equal the reference engine's, the port's whole-prompt admission
    (``prefill_chunk=0``) and its solo generate."""
    specs = [dict(uid=i, n=n, seed=80 + i) for i, n in enumerate(lens)]
    _, teng, _, treqs = run_pair(dense, specs, arrivals, n_slots=len(lens),
                                 max_len=32, prefill_chunk=chunk,
                                 chunks_per_step=cps)
    assert teng.pipeline.lanes == cps
    whole = tserve.ServeEngine(dense.tm, dense.tp, tserve.ServeConfig(
        n_slots=len(lens), max_len=32, prefill_chunk=0, chunks_per_step=cps))
    wreqs = requests(tserve, specs)
    drive(whole, wreqs, arrivals, audit=tserve.check_invariants)
    for r, w in zip(treqs, wreqs):
        assert r.out == w.out == dense.solo(r.prompt, 3), r.uid


def test_chunked_dslot_budgets_match_reference_and_solo(dslot_calibrated):
    """Per-request budgets through chunked, batched admission (a calibrated
    act_scale makes chunking exact): streams and plane accounts equal the
    reference's, and each stream equals a solo generate at its budget."""
    specs = [dict(uid=1, n=10, seed=40, n_planes=8),
             dict(uid=2, n=10, seed=41, n_planes=2),
             dict(uid=3, n=7, seed=42, n_planes=5)]
    _, teng, _, treqs = run_pair(dslot_calibrated, specs, (0, 0, 1),
                                 n_slots=2, max_len=64, prefill_chunk=4,
                                 chunks_per_step=2)
    assert teng.calibrated
    assert treqs[1].dslot_stats["planes_used_mean"] <= 2.0 + 1e-6
    for r in treqs:
        assert r.out == dslot_calibrated.solo(r.prompt, 3, r.n_planes), r.uid


@pytest.mark.parametrize("policy", ["adaptive", "per_layer"])
def test_precision_policy_grants_like_reference(dslot_uncalibrated, policy):
    from repro.runtime import AdaptiveBudget as JAdaptive
    from repro.runtime import PerLayerSchedule as JSchedule
    from repro_torch.runtime import AdaptiveBudget as TAdaptive
    from repro_torch.runtime import PerLayerSchedule as TSchedule

    if policy == "adaptive":
        kw = dict(plane_budget=4.0, min_planes=2, max_planes=8, ema=1.0)
        jpol, tpol = JAdaptive(**kw), TAdaptive(**kw)
    else:
        jpol = JSchedule({"mlp_up_dslot": 3}, default=6)
        tpol = TSchedule({"mlp_up_dslot": 3}, default=6)
    pair = dslot_uncalibrated
    jeng = jserve.ServeEngine(pair.jm, pair.jp, jserve.ServeConfig(
        n_slots=1, max_len=32, precision_policy=jpol))
    teng = tserve.ServeEngine(pair.tm, pair.tp, tserve.ServeConfig(
        n_slots=1, max_len=32, precision_policy=tpol))
    specs = [dict(uid=i, n=2, seed=i, max_new=2) for i in range(3)]
    jreqs, treqs = requests(jserve, specs), requests(tserve, specs)
    drive(jeng, jreqs, (0, 0, 0))
    drive(teng, treqs, (0, 0, 0))
    same_requests(treqs, jreqs)
    assert [r.n_planes for r in treqs] == [r.n_planes for r in jreqs]
    if policy == "adaptive":
        assert tpol.cost_ratio == pytest.approx(jpol.cost_ratio, abs=1e-6)
        assert tpol.last_feedback.n_planes == treqs[-1].n_planes
    else:
        assert [r.n_planes for r in treqs] == [3, 3, 3]


def test_streaming_and_cancel_match_reference(dslot_calibrated):
    """``on_token`` pushes and the ``stream`` generator see every token at
    its step; cancelling a decoding and a queued request attaches their
    terminal results — as in the reference."""
    def run(mod, eng):
        pushed = []
        r1 = mod.Request(uid=1, prompt=prompt(6, 1), max_new=4,
                         on_token=lambda req, tok, step:
                         pushed.append((tok, step)))
        r2 = mod.Request(uid=2, prompt=prompt(6, 2), max_new=3)
        assert eng.try_add(r1)
        streamed = list(eng.stream(r2))
        r3 = mod.Request(uid=3, prompt=prompt(4, 3), max_new=8)
        r4 = mod.Request(uid=4, prompt=prompt(4, 4), max_new=8)
        assert eng.try_add(r3) and eng.try_add(r4)
        for _ in range(3):
            eng.step()
        assert eng.cancel(3) and eng.cancel(4) and not eng.cancel(99)
        while not r1.done:
            eng.step()
        return streamed, pushed, [r1, r2, r3, r4]

    jeng, teng = dslot_calibrated.engines(n_slots=2, max_len=64,
                                          prefill_chunk=4)
    js, jpush, jreqs = run(jserve, jeng)
    ts, tpush, treqs = run(tserve, teng)
    assert (ts, tpush) == (js, jpush)
    same_requests(treqs, jreqs)
    assert ts == treqs[1].out and [t for t, _ in tpush] == treqs[0].out
    assert treqs[2].phase == treqs[3].phase == tserve.CANCELLED


# ------------------------------------------------------------- surface

def test_public_surface_matches_reference():
    from repro_torch.serve import (FaultInjector, FaultPlan,  # noqa: F401
                                   Request, ServeConfig, ServeEngine,
                                   SloConfig, SloController, audit_engine,
                                   check_invariants)
    assert sorted(tserve.__all__) == sorted(jserve.__all__)
    jfields = {f.name for f in dataclasses.fields(jserve.ServeConfig)}
    tfields = {f.name for f in dataclasses.fields(tserve.ServeConfig)}
    assert jfields - tfields == {"jit_prefill"}
    assert tfields <= jfields
    for name in tfields:
        assert getattr(tserve.ServeConfig(), name) == \
            getattr(jserve.ServeConfig(), name), name


def _bad_requests(mod):
    return {
        "2-D": mod.Request(uid=1, prompt=np.ones((2, 3), np.int32),
                           max_new=2),
        "float": mod.Request(uid=2, prompt=np.ones(3, np.float32),
                             max_new=2),
        "empty": mod.Request(uid=3, prompt=np.zeros(0, np.int32),
                             max_new=2),
        "vocab": mod.Request(uid=4, prompt=np.asarray([1, 256], np.int32),
                             max_new=2),
        "negative": mod.Request(uid=5, prompt=np.asarray([-1], np.int32),
                                max_new=2),
        "max_new": mod.Request(uid=6, prompt=prompt(3), max_new=0),
        "too_long": mod.Request(uid=7, prompt=prompt(30), max_new=5),
        "tier": mod.Request(uid=8, prompt=prompt(3), max_new=2,
                            tier="platinum"),
        "uncalibrated": mod.Request(uid=9, prompt=prompt(10), max_new=2,
                                    n_planes=4),
    }


def test_try_add_rejects_like_reference(dslot_uncalibrated):
    jeng, teng = dslot_uncalibrated.engines(n_slots=1, max_len=32,
                                            prefill_chunk=4)
    jbad, tbad = _bad_requests(jserve), _bad_requests(tserve)
    for name in jbad:
        with pytest.raises(ValueError) as je:
            jeng.try_add(jbad[name])
        with pytest.raises(ValueError) as te:
            teng.try_add(tbad[name])
        assert str(te.value) == str(je.value), name
    assert not tserve.audit_engine(teng) and teng.queue_depth == 0
    ok = tserve.Request(uid=10, prompt=prompt(3), max_new=2, n_planes=4)
    ok2 = tserve.Request(uid=11, prompt=prompt(10), max_new=2)
    assert teng.try_add(ok) and teng.try_add(ok2)


def test_queue_bound_and_legacy_keywords(dense):
    full = tserve.ServeEngine(dense.tm, dense.tp, tserve.ServeConfig(
        n_slots=1, max_len=32, max_queue=2))
    reqs = requests(tserve, [dict(uid=i, n=3, seed=i) for i in range(3)])
    assert full.try_add(reqs[0]) and full.try_add(reqs[1])
    assert not full.try_add(reqs[2]) and reqs[2].enqueue_step is None
    tengine._LEGACY_WARNED.clear()
    with pytest.warns(DeprecationWarning, match="deprecated"):
        eng = tserve.ServeEngine(dense.tm, dense.tp, n_slots=2, max_len=16,
                                 serve_config=tserve.ServeConfig(
                                     prefill_chunk=4))
    assert (eng.cfg.n_slots, eng.cfg.max_len, eng.cfg.prefill_chunk) == \
        (2, 16, 4)
    assert eng.serve_config is eng.cfg
    with warnings.catch_warnings():
        warnings.simplefilter("error")         # warned once per process
        tserve.ServeEngine(dense.tm, dense.tp, n_slots=1)
    with pytest.raises(TypeError, match="not both"):
        tserve.ServeEngine(dense.tm, dense.tp, tserve.ServeConfig(),
                           n_slots=2)
