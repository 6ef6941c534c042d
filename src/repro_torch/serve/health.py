"""Engine self-auditing: the slot/queue/lane/ring accounting invariants
(port of ``repro.serve.health``).

``check_invariants(engine)`` is the crash-consistency oracle the hardening
contract is stated against: after ANY ``step()`` — including one that
absorbed an injected exception, quarantined a poisoned slot, evicted a
timed-out request, or retried a transient lane failure — the engine must
still satisfy every invariant here, and the next ``step()`` must be able to
proceed.  The chaos tests call it after every tick.

The invariants (violations are collected, not short-circuited, so one
corrupted run reports everything that went wrong):

* **slots** — ``slot_req`` has exactly ``n_slots`` entries; every occupied
  slot holds a live (not ``done``) request in the DECODING phase, uids are
  unique across the whole engine.
* **admission lanes** — every in-flight ``PrefillTask`` reserves a distinct
  in-range slot that the pool does not also consider occupied, holds a
  distinct in-range lane, and has consumed a sane prefix of
  its prompt (``0 <= offset < len(prompt)``, PREFILLING, not done).
* **queue** — only PENDING, not-done requests; ``queue_depth`` equals
  queued + in-flight; ``max_queue`` (when set) is respected.
* **ring positions** — for every DECODING slot, the model's absolute
  position counter equals ``len(prompt) + len(out)`` exactly (each engine
  step that decodes advances both by one) and never exceeds ``max_len``
  (the ``try_add`` ring-wrap guard, re-checked here against the live
  state).
* **terminal states** — a closed engine holds no work at all.

``check_invariants`` raises :class:`InvariantViolation` listing every
failure; ``audit_engine`` returns the list instead (a caller can gate on it
being empty without exception plumbing per step).
"""

from __future__ import annotations

from repro_torch.serve.prefill import DECODING, PENDING, PREFILLING

__all__ = ["InvariantViolation", "audit_engine", "check_invariants"]


class InvariantViolation(AssertionError):
    """Engine accounting is corrupt; carries every violated invariant."""

    def __init__(self, problems: list[str]):
        self.problems = list(problems)
        super().__init__(
            "engine invariants violated:\n  - " + "\n  - ".join(problems))


def audit_engine(engine) -> list[str]:
    """Audit an engine's accounting; returns [] when every invariant holds.

    Pure inspection — nothing is mutated, no model work runs.  The one
    device interaction is a copy of the (B,) position vector to the host
    for the ring check, so calling this every step is cheap enough for
    tests and benchmarks (skip it in a production loop).
    """
    problems: list[str] = []
    pipe = engine.pipeline
    n_slots = engine.n_slots

    if len(engine.slot_req) != n_slots:
        problems.append(
            f"slot_req has {len(engine.slot_req)} entries, expected "
            f"{n_slots}")

    # ------------------------------------------------------------ slots
    seen_uids: dict[int, str] = {}
    for i, req in enumerate(engine.slot_req):
        if req is None:
            continue
        where = f"slot {i}"
        if req.uid in seen_uids:
            problems.append(f"uid {req.uid} in {where} AND "
                            f"{seen_uids[req.uid]}")
        seen_uids[req.uid] = where
        if req.done:
            problems.append(f"{where}: request {req.uid} is done but still "
                            "occupies the pool")
        if req.phase != DECODING:
            problems.append(f"{where}: request {req.uid} has phase "
                            f"{req.phase!r}, expected {DECODING!r}")

    # ------------------------------------------------- admission lanes
    held_slots: set[int] = set()
    held_lanes: set[int] = set()
    for task in pipe.active:
        req = task.req
        where = f"prefill task uid={req.uid}"
        if req.uid in seen_uids:
            problems.append(f"uid {req.uid} in {where} AND "
                            f"{seen_uids[req.uid]}")
        seen_uids[req.uid] = where
        if not (0 <= task.slot < n_slots):
            problems.append(f"{where}: slot {task.slot} out of range")
        elif engine.slot_req[task.slot] is not None:
            problems.append(f"{where}: reserved slot {task.slot} is ALSO "
                            "occupied by the decode pool")
        if task.slot in held_slots:
            problems.append(f"{where}: slot {task.slot} double-booked")
        held_slots.add(task.slot)
        if not (0 <= task.lane < pipe.lanes):
            problems.append(f"{where}: lane {task.lane} out of range "
                            f"[0, {pipe.lanes})")
        if task.lane in held_lanes:
            problems.append(f"{where}: lane {task.lane} double-booked")
        held_lanes.add(task.lane)
        if not (0 <= task.offset < len(req.prompt)):
            problems.append(
                f"{where}: offset {task.offset} outside prompt "
                f"[0, {len(req.prompt)})")
        if req.done:
            problems.append(f"{where}: request is done but still in flight")
        if req.phase != PREFILLING:
            problems.append(f"{where}: phase {req.phase!r}, expected "
                            f"{PREFILLING!r}")

    # ------------------------------------------------------------ queue
    for req in pipe.queue:
        where = f"queued uid={req.uid}"
        if req.uid in seen_uids:
            problems.append(f"uid {req.uid} in {where} AND "
                            f"{seen_uids[req.uid]}")
        seen_uids[req.uid] = where
        if req.done:
            problems.append(f"{where}: done request still queued")
        if req.phase != PENDING:
            problems.append(f"{where}: phase {req.phase!r}, expected "
                            f"{PENDING!r}")
    if engine.queue_depth != len(pipe.queue) + len(pipe.active):
        problems.append(
            f"queue_depth {engine.queue_depth} != queued "
            f"{len(pipe.queue)} + in-flight {len(pipe.active)}")
    if pipe.max_queue is not None and len(pipe) > pipe.max_queue:
        problems.append(f"admission backlog {len(pipe)} exceeds max_queue "
                        f"{pipe.max_queue}")

    # -------------------------------------------------- ring positions
    pos = engine.state.get("pos") if isinstance(engine.state, dict) else None
    if pos is not None:
        pos = pos.cpu().tolist()
        for i, req in enumerate(engine.slot_req):
            if req is None:
                continue
            expect = len(req.prompt) + len(req.out)
            if int(pos[i]) != expect:
                problems.append(
                    f"slot {i}: ring position {int(pos[i])} != "
                    f"len(prompt)+len(out) = {expect} (uid {req.uid})")
            if int(pos[i]) > engine.max_len:
                problems.append(
                    f"slot {i}: ring position {int(pos[i])} exceeds "
                    f"max_len {engine.max_len} (uid {req.uid})")

    # --------------------------------------------------------- closed
    if getattr(engine, "closed", False):
        if seen_uids:
            problems.append(
                f"closed engine still holds work: {sorted(seen_uids)}")

    return problems


def check_invariants(engine) -> None:
    """Raise :class:`InvariantViolation` unless every invariant holds."""
    problems = audit_engine(engine)
    if problems:
        raise InvariantViolation(problems)
