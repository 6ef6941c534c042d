"""Port parity for the serving engine's host-side control planes
(``repro_torch.serve.slo`` and ``repro_torch.serve.faults``) against the JAX
reference (``repro.serve.slo`` / ``repro.serve.faults``).

Both are plain host logic, so the bar is equality: the same seeded numpy
sequence of load signals drives both SLO controllers to the same levels,
budgets and shed/restore events at every step, and the same fault plan arms
and fires the same faults at the same steps in both injectors.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch
import torch_one_thread  # noqa: F401  (PyTorch on one CPU thread)

from repro.serve import faults as jfaults
from repro.serve import slo as jslo
from repro_torch.serve import faults as tfaults
from repro_torch.serve import slo as tslo

N_BITS = 8


def signal_sequence(seed, n):
    """``n`` load snapshots from a seed: bursts (deep queues, slow first
    tokens, occasional timeouts) alternating with idle stretches (empty
    queue, now and then a quick first token)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        if (i // 25) % 2 == 0:
            depth = int(rng.integers(0, 9))
            ttfts = rng.integers(1, 20, int(rng.integers(0, 3)))
            timed_out = int(rng.random() < 0.05)
        else:
            depth = int(rng.random() < 0.05)
            ttfts = rng.integers(1, 4, int(rng.random() < 0.1))
            timed_out = 0
        out.append(dict(queue_depth=depth,
                        ttft_steps=[int(t) for t in ttfts],
                        decode_stalled=bool(rng.integers(2)),
                        planes_used_mean=float(rng.uniform(1, 8)),
                        timed_out=timed_out))
    return out


CONFIGS = {
    "default": {},
    "eager": dict(queue_high_water=1, shed_patience=1, restore_patience=2,
                  target_ttft_steps=100),
    "ttft": dict(target_ttft_steps=4, ttft_window=8, ttft_idle_expiry=3,
                 shed_step=2, restore_step=3),
    "custom_tiers": dict(tiers="custom"),
}


def tier_table(mod):
    return {"gold": mod.TierSpec(floor=99, ceiling=99, shed_order=2),
            "silver": mod.TierSpec(floor=3, ceiling=7, shed_order=1),
            "bronze": mod.TierSpec(floor=0, ceiling=8, shed_order=0)}


def controller_pair(name):
    kw = dict(CONFIGS[name])
    if kw.pop("tiers", None):
        jkw, tkw = dict(kw, tiers=tier_table(jslo)), \
            dict(kw, tiers=tier_table(tslo))
    else:
        jkw = tkw = kw
    return (jslo.SloController(N_BITS, jslo.SloConfig(**jkw)),
            tslo.SloController(N_BITS, tslo.SloConfig(**tkw)))


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("seed", [0, 1])
def test_slo_controller_matches_reference_step_for_step(name, seed):
    jc, tc = controller_pair(name)
    assert {k: dataclasses.asdict(v) for k, v in tc.tiers.items()} == \
        {k: dataclasses.asdict(v) for k, v in jc.tiers.items()}
    rng = np.random.default_rng(100 + seed)
    for i, sig in enumerate(signal_sequence(seed, 150)):
        jl = jc.update(jslo.SloSignals(**sig))
        tl = tc.update(tslo.SloSignals(**sig))
        assert tl == jl, i
        assert (tc.shed_events, tc.restore_events, tc.min_levels,
                tc.ttft_p95()) == (jc.shed_events, jc.restore_events,
                                   jc.min_levels, jc.ttft_p95()), i
        for tier in tc.tiers:
            for n in range(1, N_BITS + 1):
                assert tc.budget_for(tier, n) == jc.budget_for(tier, n)
            assert tc.floor(tier) == jc.floor(tier)
        if i % 7 == 0:
            fb = dict(n_planes=int(rng.integers(1, 9)),
                      planes_used_mean=float(rng.uniform(0, 8)),
                      skipped_frac=float(rng.uniform(0, 1)),
                      tier=str(rng.choice(sorted(tc.tiers))))
            jc.observe(jslo.PolicyFeedback(**fb))
            tc.observe(tslo.PolicyFeedback(**fb))
    assert tc.summary() == jc.summary()
    assert tc.shed_events > 0 and tc.restore_events > 0


def test_default_tiers_match_reference():
    for n in (1, 2, 4, 8):
        assert {k: dataclasses.asdict(v)
                for k, v in tslo.default_tiers(n).items()} == \
            {k: dataclasses.asdict(v)
             for k, v in jslo.default_tiers(n).items()}
    assert tslo.TIERS == jslo.TIERS


# ------------------------------------------------------------- faults

def plan_pair(faults, seed=None):
    return (jfaults.FaultPlan(faults=tuple(jfaults.Fault(**f) for f in faults),
                              seed=seed),
            tfaults.FaultPlan(faults=tuple(tfaults.Fault(**f) for f in faults),
                              seed=seed))


@pytest.mark.parametrize("seed", [3, 7, 11])
def test_random_plan_matches_reference(seed):
    kw = dict(n_faults=8, max_step=20, n_slots=4, uids=(1, 2, 3),
              kinds=tfaults.FAULT_KINDS)
    j = jfaults.FaultPlan.random(seed, **kw)
    t = tfaults.FaultPlan.random(seed, **kw)
    assert [dataclasses.asdict(f) for f in t.faults] == \
        [dataclasses.asdict(f) for f in j.faults]
    assert t.seed == j.seed == seed and len(t) == len(j) == 8
    assert t == tfaults.FaultPlan.random(seed, **kw)
    assert tfaults.FAULT_KINDS == jfaults.FAULT_KINDS


def test_fault_validates_kind():
    with pytest.raises(ValueError, match="unknown fault kind"):
        tfaults.Fault(kind="meteor_strike", step=1)


def _consult(inj, mod, logits, resolve, lib):
    """One step of every hook, in the engine's order; returns what each
    hook did (raises as the exception's message)."""
    out = {"slow": [f.kind for f in inj.slow_steps()],
           "cancel": inj.cancels()}
    for site in ("admission_tick", "lane_forward", "decode_forward"):
        raised = []
        for _ in range(3):
            try:
                inj.raise_if(site)
            except mod.TransientFault as e:
                raised.append(str(e))
        out[site] = raised
    lg, poisoned = inj.poison_logits(logits, resolve)
    out["poisoned"] = poisoned
    out["rows"] = [bool(v) for v in np.asarray(
        lib(lg)).reshape(lg.shape[0], -1).all(axis=1)]
    out["kv"] = inj.kv_corruptions(resolve)
    return out


def test_injector_fires_like_reference():
    """A plan with every fault kind, uid targets that resolve only from a
    later step, and multi-count exceptions: both injectors fire the same
    faults at the same steps, poison the same logit rows, and end with the
    same replay record."""
    faults = [
        dict(kind="slow_step", step=2, value=0.0),
        dict(kind="cancel", step=3, uid=5),
        dict(kind="admission_exception", step=2, count=2),
        dict(kind="lane_exception", step=4, count=1),
        dict(kind="decode_exception", step=5, count=4),
        dict(kind="nan_logits", step=1, uid=9),
        dict(kind="inf_logits", step=6, slot=2),
        dict(kind="kv_corrupt", step=3, uid=9),
        dict(kind="kv_corrupt", step=7, slot=0),
    ]
    jp, tp = plan_pair(faults, seed=None)
    ji, ti = jfaults.FaultInjector(jp), tfaults.FaultInjector(tp)
    base = np.random.default_rng(0).normal(size=(4, 6)).astype(np.float32)

    def resolver(step):
        # uid 9 reaches slot 1 at step 5; slot targets resolve as planned
        return lambda f: (1 if step >= 5 else None) if f.uid is not None \
            else f.slot

    for step in range(1, 10):
        ji.begin_step(step)
        ti.begin_step(step)
        j = _consult(ji, jfaults, jnp.asarray(base), resolver(step),
                     jnp.isfinite)
        t = _consult(ti, tfaults, torch.as_tensor(base), resolver(step),
                     torch.isfinite)
        assert t == j, step
        assert ti.exhausted == ji.exhausted
    assert ti.fired == ji.fired
    assert ti.summary() == ji.summary()
    assert ti.exhausted


def test_uid_fault_stays_pending_until_resolvable():
    plan = tfaults.FaultPlan(faults=(tfaults.Fault(kind="nan_logits", step=1,
                                                   uid=42),))
    inj = tfaults.FaultInjector(plan)
    inj.begin_step(3)
    lg = torch.zeros((2, 8))
    out, poisoned = inj.poison_logits(lg, lambda f: None)
    assert not poisoned and not inj.exhausted
    out, poisoned = inj.poison_logits(lg, lambda f: 1)
    assert poisoned and inj.exhausted
    assert bool(torch.isnan(out[1]).all()) and bool((out[0] == 0).all())
    assert bool((lg == 0).all()), "the computed logits are not written"
