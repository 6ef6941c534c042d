"""Port parity for the serving engine's hardening (``repro_torch.serve``:
fault plane, retries, quarantine, deadlines, the invariant auditor) against
the JAX reference, on the reduced f32 olmo-1b config.

The same fault plan and requests go through both engines: the logged error
sites, quarantined uids, timeouts, phases and every request's tokens must
be equal, and ``check_invariants`` must hold after every port step.

The port's model writes its KV rings in place where the reference returns
new state, so a forward that raises part-way leaves rows written.  The
retry tests raise from the second layer, after the first has written its
ring rows, and hold the streams to a fault-free reference run.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch_one_thread  # noqa: F401  (PyTorch on one CPU thread)

import repro.serve as jserve
import repro_torch.serve as tserve
from repro.models.model_zoo import build_model as jbuild
from repro_torch.models import transformer as ttr
from repro_torch.models.model_zoo import build_model as tbuild

from test_torch_models import cfg_pair, ref_params


@pytest.fixture(scope="module")
def lm():
    jc, tc = cfg_pair("olmo-1b")
    p, tp = ref_params(jc, seed=3)
    return jbuild(jc), jax.tree.map(jnp.asarray, p), tbuild(tc), tp


def prompt(n, seed=0):
    return np.random.RandomState(seed).randint(0, 256, size=n).astype(
        np.int32)


def engines(lm, faults=(), **cfg):
    jm, jp, tm, tp = lm
    jplan = jserve.FaultPlan(faults=tuple(jserve.Fault(**f) for f in faults))
    tplan = tserve.FaultPlan(faults=tuple(tserve.Fault(**f) for f in faults))
    return (jserve.ServeEngine(jm, jp, jserve.ServeConfig(faults=jplan,
                                                          **cfg)),
            tserve.ServeEngine(tm, tp, tserve.ServeConfig(faults=tplan,
                                                          **cfg)))


def requests(mod, specs):
    return [mod.Request(uid=s["uid"], prompt=prompt(s["n"], s["seed"]),
                        max_new=s["max_new"],
                        deadline_steps=s.get("deadline_steps"))
            for s in specs]


def run(eng, reqs, audit=False, before_step=None, max_steps=100):
    for r in reqs:
        assert eng.try_add(r)
    for _ in range(max_steps):
        if all(r.done for r in reqs):
            return
        if before_step is not None:
            before_step(eng)
        eng.step()
        if audit:
            tserve.check_invariants(eng)
    raise AssertionError("requests not terminal")


def outcome(eng, reqs):
    return dict(
        errors=[(s, site) for s, site, _ in eng.errors],
        quarantined=eng.quarantined, timeouts=eng.timeouts,
        fired=None if eng.injector is None else eng.injector.fired,
        reqs=[(r.uid, r.phase, r.out, r.token_steps,
               None if r.result is None else r.result.phase)
              for r in reqs])


SPECS = [dict(uid=1, n=6, seed=1, max_new=8),
         dict(uid=2, n=9, seed=2, max_new=8),
         dict(uid=3, n=7, seed=3, max_new=20),
         dict(uid=4, n=5, seed=4, max_new=6),
         dict(uid=5, n=10, seed=5, max_new=6),
         dict(uid=6, n=4, seed=6, max_new=20, deadline_steps=9),
         dict(uid=7, n=8, seed=7, max_new=5)]

CHAOS = [dict(kind="admission_exception", step=2, count=1),
         dict(kind="lane_exception", step=3, count=2),
         dict(kind="nan_logits", step=6, uid=2),
         dict(kind="kv_corrupt", step=5, uid=3),
         dict(kind="decode_exception", step=7, count=3),
         dict(kind="cancel", step=3, uid=7),
         dict(kind="cancel", step=8, uid=4),
         dict(kind="cancel", step=8, uid=99),
         dict(kind="slow_step", step=4, value=0.0)]


def test_chaos_plan_matches_reference(lm):
    """A transient admission fault, lane faults within the retry budget, a
    NaN-logits poison, a KV corruption, a decode fault past the budget, a
    cancel storm (a queued, a decoding and an unknown uid) and a deadline
    timeout: the same outcome in both engines, and the survivors' streams
    equal solo generate."""
    jeng, teng = engines(lm, CHAOS, n_slots=3, max_len=64, prefill_chunk=4,
                         chunks_per_step=2)
    jreqs, treqs = requests(jserve, SPECS), requests(tserve, SPECS)
    run(jeng, jreqs)
    run(teng, treqs, audit=True)
    got, want = outcome(teng, treqs), outcome(jeng, jreqs)
    assert got == want
    assert [e[2] for e in teng.errors] == [e[2] for e in jeng.errors]
    phases = {r.uid: r.phase for r in treqs}
    assert phases == {1: "done", 2: "quarantined", 3: "quarantined",
                      4: "cancelled", 5: "done", 6: "timeout",
                      7: "cancelled"}
    assert {s for _, s in got["errors"]} == {"admission", "decode"}
    _, _, tm, tp = lm
    for r in treqs:
        if r.phase == tserve.DONE:
            solo = tserve.generate(tm, tp, {"tokens": torch.as_tensor(
                r.prompt[None])}, r.max_new)
            assert r.out == solo.tokens[0].tolist(), r.uid
    assert not tserve.audit_engine(teng)
    teng.close()
    assert teng.closed and not tserve.audit_engine(teng)


@pytest.mark.parametrize("seed", [1, 2])
def test_random_plan_matches_reference(lm, seed):
    """A seeded storm over every engine-side fault kind: the same replay
    record and outcome in both engines."""
    kinds = ("nan_logits", "lane_exception", "decode_exception",
             "kv_corrupt", "admission_exception", "cancel")
    jplan = jserve.FaultPlan.random(seed, n_faults=6, max_step=14,
                                    n_slots=3, uids=(1, 2, 3, 4),
                                    kinds=kinds)
    faults = [dict(kind=f.kind, step=f.step, slot=f.slot, uid=f.uid,
                   count=f.count) for f in jplan.faults]
    jeng, teng = engines(lm, faults, n_slots=3, max_len=64,
                         prefill_chunk=4, chunks_per_step=2)
    specs = SPECS[:4]
    jreqs, treqs = requests(jserve, specs), requests(tserve, specs)
    run(jeng, jreqs)
    run(teng, treqs, audit=True)
    assert outcome(teng, treqs) == outcome(jeng, jreqs)


def test_deadlines_drain_and_close_match_reference(lm):
    def go(mod, eng):
        r1 = mod.Request(uid=1, prompt=prompt(4, 5), max_new=50,
                         deadline_steps=3)
        r2 = mod.Request(uid=2, prompt=prompt(6, 6), max_new=4)
        r3 = mod.Request(uid=3, prompt=prompt(5, 7), max_new=30)
        assert eng.try_add(r1) and eng.try_add(r2)
        done = eng.drain()
        assert eng.try_add(r3)
        for _ in range(2):
            eng.step()
        cancelled = eng.close()
        with pytest.raises(RuntimeError, match="closed"):
            eng.step()
        return ([r.uid for r in done], [r.uid for r in cancelled],
                eng.timeouts, [(r.uid, r.phase, r.out, r.result.phase)
                               for r in (r1, r2, r3)])

    jeng, teng = engines(lm, n_slots=2, max_len=64, prefill_chunk=4)
    assert go(tserve, teng) == go(jserve, jeng)
    assert teng.close() == []


# ------------------------------------------------- retry after partial write

class LayerFault:
    """Wraps ``transformer.apply_layer``: while armed, the second layer of
    a decode-step forward (``lane=False``) or of a lane forward
    (``lane=True``) raises — after the first layer has written its ring."""

    def __init__(self, orig, lane: bool):
        self.orig, self.lane, self.left, self.calls = orig, lane, 0, 0

    def __call__(self, p, x, cfg, kind, **kw):
        if self.left and kw.get("mode") == "decode" \
                and (x.shape[1] > 1) == self.lane:
            self.calls += 1
            if self.calls % cfg.n_layers == 0:
                self.left -= 1
                raise RuntimeError("layer fault after the first layer wrote")
        return self.orig(p, x, cfg, kind, **kw)


@pytest.mark.parametrize("lane", [False, True])
@pytest.mark.parametrize("count", [1, 3])
def test_retry_after_partial_ring_write(lm, monkeypatch, lane, count):
    """A forward that raises after the first layer wrote its ring rows:
    once (the retry succeeds) and past the retry budget (the decode stalls a
    step; the admission fails its in-flight tasks).  The port's outcome
    equals the reference's run with the same failure injected before the
    forward, where nothing was written — so the rows a failed attempt wrote
    changed no token."""
    fault = LayerFault(ttr.apply_layer, lane)
    monkeypatch.setattr(ttr, "apply_layer", fault)
    step = 3 if lane else 5
    kind = "lane_exception" if lane else "decode_exception"
    jeng, teng = engines(lm, [dict(kind=kind, step=step, count=count)],
                         n_slots=3, max_len=64, prefill_chunk=4,
                         chunks_per_step=2)
    teng.injector = teng.pipeline.injector = None
    specs = SPECS[:3] + [dict(uid=8, n=13, seed=8, max_new=6)]
    jreqs, treqs = requests(jserve, specs), requests(tserve, specs)
    written = []

    def arm(eng):
        if eng.steps + 1 == step:
            fault.left = count
        elif eng.steps == step and not lane and count == 3:
            # the stalled step: layer 0 wrote every slot's ring row at its
            # position, and pos did not advance
            pos = eng.state["pos"]
            ring = eng.state["caches"][0].positions
            C = ring.shape[1]
            written.append(all(int(ring[i, int(pos[i]) % C]) == int(pos[i])
                               for i, r in enumerate(eng.slot_req)
                               if r is not None))

    run(jeng, jreqs)
    run(teng, treqs, audit=True, before_step=arm)
    assert fault.left == 0 and fault.calls == 2 * count
    got, want = outcome(teng, treqs), outcome(jeng, jreqs)
    got.pop("fired"), want.pop("fired")
    assert got == want
    assert len(teng.errors) == count
    if not lane and count == 3:
        assert written == [True]


# ------------------------------------------------------------- auditor

def _corrupt(kind, eng, bump_pos):
    decoding = [i for i, r in enumerate(eng.slot_req) if r is not None]
    i = decoding[0]
    if kind == "pos":
        bump_pos(eng, i)
    elif kind == "done":
        eng.slot_req[i].done = True
    elif kind == "duplicate":
        free = eng.slot_req.index(None)
        eng.slot_req[free] = eng.slot_req[i]
    elif kind == "lane":
        eng.pipeline.active[0].lane = 7
    elif kind == "queued_phase":
        eng.pipeline.queue[0].phase = "decoding"
    elif kind == "offset":
        eng.pipeline.active[-1].offset = 99


def _jax_bump(eng, i):
    eng.state["pos"] = eng.state["pos"].at[i].add(1)


def _torch_bump(eng, i):
    eng.state["pos"][i] += 1


@pytest.mark.parametrize("kind", ["pos", "done", "duplicate", "lane",
                                  "queued_phase", "offset"])
def test_auditor_flags_what_reference_flags(lm, kind):
    """The same deliberately corrupted state in both engines: the auditor
    reports the same violations, and ``check_invariants`` raises them."""
    jeng, teng = engines(lm, n_slots=4, max_len=64, prefill_chunk=4,
                         chunks_per_step=2)
    specs = [dict(uid=1, n=3, seed=1, max_new=8),
             dict(uid=2, n=9, seed=2, max_new=8),
             dict(uid=3, n=13, seed=3, max_new=8),
             dict(uid=4, n=5, seed=4, max_new=8)]
    for eng, mod, bump in ((jeng, jserve, _jax_bump),
                           (teng, tserve, _torch_bump)):
        for r in requests(mod, specs):
            assert eng.try_add(r)
        eng.step()
        eng.step()
        assert mod.audit_engine(eng) == []
        _corrupt(kind, eng, bump)
    problems = tserve.audit_engine(teng)
    assert problems and problems == jserve.audit_engine(jeng)
    with pytest.raises(tserve.InvariantViolation) as err:
        teng.check_invariants()
    assert err.value.problems == problems
