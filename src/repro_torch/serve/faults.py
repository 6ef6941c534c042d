"""Deterministic fault-injection plane for the serving engine (port of
``repro.serve.faults``).

The engine's hardening contracts (quarantine isolation, crash-consistent
``step()``, deadline eviction, graceful drain — see ``serve/engine.py`` and
``docs/serving.md`` "Failure modes and recovery") are only worth anything
if they can be *exercised on demand*: a NaN logit or a failed kernel
launch shows up once a week in production and never in CI.  This module
makes failure a first-class, **replayable** input: a :class:`FaultPlan` is
a plain declarative list of :class:`Fault` records (what kind, which engine
step, which slot/request), the engine builds one :class:`FaultInjector` per
run from ``ServeConfig.faults``, and consults it at five fixed hook points:

===================  ========================================================
hook (where)          fault kinds it serves
===================  ========================================================
step begin (engine)  ``slow_step`` (artificial latency), ``cancel``
                     (cancel storms driven from the plan, so a storm is as
                     replayable as any other fault)
admission tick       ``admission_exception`` — raised from inside the
(engine)             engine's admission work, before any pipeline state
                     moves
lane forward         ``lane_exception`` — raised from inside
(prefill pipeline)   ``PrefillPipeline`` immediately before the batched
                     chunk forward, the spot a real kernel failure would
                     surface
post-forward logits  ``nan_logits`` / ``inf_logits`` — poison one slot's
(engine)             logit row AFTER the pooled decode forward (a
                     ``where`` on the computed logits: nothing leaks into
                     other rows)
ring write (engine)  ``kv_corrupt`` — scribble NaN over one slot's
                     floating-point KV-ring rows after the step's state
                     commit (int leaves — ring positions — are left alone)
decode forward       ``decode_exception`` — raised before the pooled
(engine)             decode call (exercises the bounded-retry path)
===================  ========================================================

Determinism and replay: a plan is immutable; an injector consumes its own
working copy and records every fault it actually fired (``fired`` — step,
kind, target) so a chaos run can be audited and replayed exactly.  Faults
whose target is a request (``uid=``) stay *pending* until the target is
resolvable (e.g. the request reaches a decode slot) and fire at the first
eligible step — the plan says "poison request 7 once it is decoding, from
step 5 on", not "hope request 7 is in slot 2 at step 5".  Exception faults
raise ``count`` times total (one per consult), so a ``count=2`` transient
fault exercises exactly two retries and then heals.

``FaultPlan.random(seed, ...)`` draws a seeded storm (same seed, same
plan) for property tests.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable

import numpy as np

import torch

__all__ = ["Fault", "FaultPlan", "FaultInjector", "TransientFault",
           "FAULT_KINDS"]

FAULT_KINDS = ("nan_logits", "inf_logits", "kv_corrupt", "lane_exception",
               "admission_exception", "decode_exception", "cancel",
               "slow_step")

# exception kinds -> the hook (consult site) they fire at
_RAISE_SITES = {"lane_exception": "lane_forward",
                "admission_exception": "admission_tick",
                "decode_exception": "decode_forward"}


class TransientFault(RuntimeError):
    """The injected stand-in for a transient backend failure (a lane or
    decode forward raising).  The engine's retry machinery treats it like
    any other exception; tests match on this type to distinguish injected
    faults from real bugs."""


@dataclasses.dataclass(frozen=True)
class Fault:
    """One planned fault.

    kind: one of ``FAULT_KINDS``.
    step: first engine step (the ``ServeEngine.steps`` clock) the fault is
        eligible to fire.  Target-bound faults (``uid=``) wait past this
        step until the target is resolvable.
    slot: target pool slot (``nan_logits`` / ``inf_logits`` /
        ``kv_corrupt``).  Ignored when ``uid`` is set.
    uid: target request — resolved to whatever slot the request occupies
        when the fault fires (robust to admission timing).  For ``cancel``
        this is the request to cancel.
    count: exception faults raise this many times total (one per consult);
        other kinds fire once.
    value: payload — seconds for ``slow_step``.
    """
    kind: str
    step: int
    slot: int | None = None
    uid: int | None = None
    count: int = 1
    value: float | None = None

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(known: {FAULT_KINDS})")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """An immutable, replayable set of faults (``ServeConfig.faults``).

    The plan is pure data: building an engine from the same plan (and the
    same workload) replays the same failure schedule.  ``seed`` records the
    draw that produced a :meth:`random` plan — informational, the faults
    tuple is already materialized.
    """
    faults: tuple[Fault, ...] = ()
    seed: int | None = None

    def __post_init__(self):
        object.__setattr__(self, "faults", tuple(self.faults))

    def __len__(self) -> int:
        return len(self.faults)

    @classmethod
    def random(cls, seed: int, *, n_faults: int = 4, max_step: int = 32,
               n_slots: int = 4, uids: Iterable[int] = (),
               kinds: Iterable[str] = ("nan_logits", "lane_exception",
                                       "decode_exception", "kv_corrupt"),
               ) -> "FaultPlan":
        """A seeded storm: ``n_faults`` draws over ``kinds``, steps in
        ``[1, max_step]``, slot/uid targets drawn from the given ranges.
        Same seed, same plan — the chaos property tests lean on this."""
        rng = np.random.default_rng(seed)
        kinds = tuple(kinds)
        uids = tuple(uids)
        faults = []
        for _ in range(n_faults):
            kind = kinds[int(rng.integers(len(kinds)))]
            step = int(rng.integers(1, max_step + 1))
            slot = uid = None
            if kind in ("nan_logits", "inf_logits", "kv_corrupt", "cancel"):
                if uids and (kind == "cancel" or rng.integers(2)):
                    uid = int(uids[int(rng.integers(len(uids)))])
                else:
                    slot = int(rng.integers(n_slots))
            count = int(rng.integers(1, 3)) \
                if kind in _RAISE_SITES else 1
            faults.append(Fault(kind=kind, step=step, slot=slot, uid=uid,
                                count=count))
        return cls(faults=tuple(faults), seed=seed)


@dataclasses.dataclass
class _Armed:
    """Injector-private mutable working copy of one planned fault."""
    fault: Fault
    remaining: int


class FaultInjector:
    """Consumes a :class:`FaultPlan` against a live engine run.

    The engine calls :meth:`begin_step` once per ``step()`` and then
    consults the hook methods below; each returns quickly when nothing is
    armed for the current step.  Every fault that actually fires is
    appended to ``fired`` as ``(step, kind, target)`` — the replay record.
    """

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._pending: list[_Armed] = [
            _Armed(fault=f, remaining=max(1, f.count)) for f in plan.faults]
        self.fired: list[tuple[int, str, int | None]] = []
        self.step = 0

    def begin_step(self, step: int) -> None:
        self.step = step

    @property
    def exhausted(self) -> bool:
        """True once every planned fault has fully fired."""
        return not self._pending

    # -------------------------------------------------------------- hooks

    def _take(self, kind: str, ready: Callable[[Fault], bool] | None = None
              ) -> list[Fault]:
        out = []
        for a in list(self._pending):
            f = a.fault
            if f.kind != kind or f.step > self.step:
                continue
            if ready is not None and not ready(f):
                continue                       # stays pending; retried later
            out.append(f)
            self._pending.remove(a)
        return out

    def raise_if(self, site: str) -> None:
        """Consult an exception hook (``"lane_forward"`` /
        ``"admission_tick"`` / ``"decode_forward"``): raises
        :class:`TransientFault` once per armed count, in plan order."""
        for a in self._pending:
            f = a.fault
            if (_RAISE_SITES.get(f.kind) == site and f.step <= self.step):
                a.remaining -= 1
                if a.remaining <= 0:
                    self._pending.remove(a)
                self.fired.append((self.step, f.kind, f.uid or f.slot))
                raise TransientFault(
                    f"injected {f.kind} at step {self.step} "
                    f"({a.remaining} remaining)")

    def slow_steps(self) -> list[Fault]:
        """Armed ``slow_step`` faults for this step (engine sleeps)."""
        out = self._take("slow_step")
        for f in out:
            self.fired.append((self.step, f.kind, None))
        return out

    def cancels(self) -> list[int]:
        """Request uids the plan cancels this step (cancel storms)."""
        out = self._take("cancel")
        uids = []
        for f in out:
            self.fired.append((self.step, f.kind, f.uid))
            if f.uid is not None:
                uids.append(f.uid)
        return uids

    def poison_logits(self, logits, resolve: Callable[[Fault], int | None]):
        """Post-forward logit hook: overwrite one slot's logit row with
        NaN/Inf.  ``resolve(fault)`` maps a fault to a pool slot (engine
        resolves ``uid`` targets; returns None while unresolvable, which
        keeps the fault pending).  Returns new logits: the computed ones
        are not written, and no other row is touched."""
        poisoned = False
        for kind, val in (("nan_logits", float("nan")),
                          ("inf_logits", float("inf"))):
            for f in self._take(kind, ready=lambda f: resolve(f) is not None):
                slot = resolve(f)
                self.fired.append((self.step, kind, slot))
                row = torch.arange(logits.shape[0],
                                   device=logits.device) == slot
                logits = torch.where(row[:, None], torch.tensor(
                    val, dtype=logits.dtype, device=logits.device), logits)
                poisoned = True
        return logits, poisoned

    def kv_corruptions(self, resolve: Callable[[Fault], int | None]
                       ) -> list[int]:
        """Ring-write hook: pool slots whose KV rows the engine must
        scribble this step (the engine owns the state layout)."""
        slots = []
        for f in self._take("kv_corrupt",
                            ready=lambda f: resolve(f) is not None):
            slot = resolve(f)
            self.fired.append((self.step, "kv_corrupt", slot))
            slots.append(slot)
        return slots

    def summary(self) -> dict:
        """JSON-ready account: what fired when, what never became firable."""
        return {
            "planned": len(self.plan),
            "fired": [{"step": s, "kind": k, "target": t}
                      for s, k, t in self.fired],
            "unfired": [dataclasses.asdict(a.fault) for a in self._pending],
        }
