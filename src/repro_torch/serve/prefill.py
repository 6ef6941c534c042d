"""Chunked-prefill admission pipeline (port of ``repro.serve.prefill``).

Instead of blocking the whole decode pool for one full-prompt forward per
admission, admission work is cut into fixed-size prompt chunks and the
engine interleaves it with every pooled decode step: live slots keep
decoding at their usual cadence, pending prompts trickle into their KV
caches a chunk at a time, and a slot becomes decodable the very step its
last chunk lands.

Admission work is batched: up to ``ServeConfig.chunks_per_step`` PREFILLING
requests advance together in one forward per engine step — each in its own
**lane** of a persistent stacked decode state, at its own ragged offset,
padded to the fixed chunk width, with per-lane positions and per-lane DSLOT
plane budgets (``Model.extend(..., lengths=...)``).

Lifecycle of a request::

    try_add --> PENDING ----> PREFILLING ----------> DECODING --> DONE
               (queued,       (slot + lane           (in the pooled
                FIFO)          reserved; chunks       decode step)
                               accumulate into the
                               task's lane)

Every chunk runs ``Model.extend`` on the stacked lane state, starting from a
freshly reset lane (an empty ring at position 0 extends like a one-shot
``Model.prefill``).  Lanes are private to their tasks: the pool is written
once, by the engine's ``_merge_slot`` on completion, which copies the
finished lane's rows over the reserved slot's rows.  Pooled decode steps may
write into reserved rows meanwhile; the merge overwrites them.  Cancelling a
mid-prefill request drops the task, and its lane is reset when the next
request claims it.

The port's model writes its full-attention KV rings in place; a chunk's
sliding-window rings and the recurrent states (``SSMState``,
``RGLRUState``) come back as new tensors, which the pipeline takes only
when the forward succeeds.  Lane resets and merges are row copies into the
current tensors, and a completed task carries a copy of its lane's rows, so
a lane reused by the next task cannot alias a slot.  A forward that raises
part-way has written full-attention ring rows at the chunk's positions but
not advanced ``pos``; the retry writes the same rows with the same values,
and finds every other state as it was, so the tick stays transactional.

Right-padding is harmless: pad rows write nothing new into the ring (the
attention layer writes back what the ring holds) and do not advance the
lane's position, so a ragged tail chunk costs one fixed-width forward.

The tick is HYBRID: the one batched forward advances every active lane, and
any leftover ``chunks_per_step`` budget is spent on extra chunks of the HEAD
task (FIFO).  Chunk boundaries are fixed multiples of ``chunk`` whichever
tick runs them, so the schedule never changes the computed tokens.

``chunk == 0`` means whole-prompt admission: each tick runs one batched
forward at the widest remaining prompt among the claimed tasks, so every
claimed task completes in the tick it was claimed.
"""

from __future__ import annotations

import contextlib
from collections import deque
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Any, Callable

import numpy as np
import torch

from repro_torch.models.attention import cache_capacity
from repro_torch.runtime import precision_scope
from repro_torch.tree import tree_map

if TYPE_CHECKING:                                    # pragma: no cover
    from repro_torch.serve.engine import Request

__all__ = ["PENDING", "PREFILLING", "DECODING", "DONE", "CANCELLED",
           "TIMEOUT", "QUARANTINED", "FAILED",
           "PrefillTask", "PrefillPipeline"]

# Request lifecycle phases (``Request.phase``).
PENDING = "pending"          # queued, no slot yet
PREFILLING = "prefilling"    # slot reserved, prompt chunks in flight
DECODING = "decoding"        # merged into the pool, advancing every step
DONE = "done"                # finished, slot released
CANCELLED = "cancelled"      # abandoned at any earlier phase
# Terminal eviction phases (engine hardening):
TIMEOUT = "timeout"          # deadline expired before finish; evicted
QUARANTINED = "quarantined"  # non-finite logits detected; slot isolated
FAILED = "failed"            # admission work kept raising past the retry
                             # budget; evicted so the lane can recover


@dataclass
class PrefillTask:
    """One in-flight admission: a request, its reserved pool slot, and the
    lane of the pipeline's stacked state its prompt chunks accumulate
    into."""
    req: "Request"
    slot: int
    lane: int = -1                   # row of the stacked lane state
    offset: int = 0                  # prompt tokens already processed
    state: dict | None = None        # a copy of the lane's rows, on completion
    logits: Any = None               # last chunk's final-position logits
    chunks_done: int = 0

    @property
    def remaining(self) -> int:
        return len(self.req.prompt) - self.offset


def _batch_axes(model, max_len: int):
    """The batch axis of every decode-state tensor, -1 for one with none,
    from the shapes of one- and two-row states on the ``meta`` device
    (nothing is allocated)."""
    s1 = model.init_decode_state(1, max_len, device="meta")
    s2 = model.init_decode_state(2, max_len, device="meta")

    def ax(a, b):
        diffs = [i for i, (x, y) in enumerate(zip(a.shape, b.shape))
                 if x != y]
        return diffs[0] if diffs else -1

    return tree_map(ax, s1, s2)


def extract_row(state, axes, i: int):
    """A copy of row ``i`` of every batched tensor (one-row state)."""
    return tree_map(lambda leaf, a: leaf if a < 0
                    else leaf.narrow(a, i, 1).clone(), state, axes)


def insert_row(state, row, axes, i: int) -> None:
    """Copy a one-row state into row ``i`` of ``state``, in place."""
    def put(leaf, a, r):
        if a >= 0:
            leaf.narrow(a, i, 1).copy_(r)
    tree_map(put, state, axes, row)


@dataclass
class PrefillPipeline:
    """FIFO admission queue + the chunk executor.

    The engine calls :meth:`tick` once per step with a free-slot provider;
    the pipeline claims queue heads into slots (and lanes) as they become
    available and advances every in-flight task by one chunk in ONE batched
    forward (``chunks_per_step`` lanes), spending any leftover budget on
    extra chunks of the head task (the hybrid tick) — returning completed
    tasks for the engine to merge into the pool.
    """
    model: Any
    params: Any
    max_len: int
    device: torch.device
    chunk: int = 32
    chunks_per_step: int = 1
    max_queue: int | None = None
    dslot: bool = False          # model runs the digit-serial MLP path
    calibrated: bool = True      # prepared weights carry an act scale
    queue: deque = field(default_factory=deque)
    active: list = field(default_factory=list)   # in-flight PrefillTasks
    forwards: int = 0                            # model forwards run (a
                                                 # batched tick counts 1)
    injector: Any = None         # repro_torch.serve.faults.FaultInjector —
                                 # the engine installs its own; consulted
                                 # just before every lane forward
    split: Callable = contextlib.nullcontext   # the context every lane
                                 # state and forward runs in (the engine's
                                 # ``pspec.model_shard`` under a mesh)

    def __post_init__(self):
        cap = cache_capacity(self.model.cfg, self.max_len)
        if self.chunk > cap:
            # chunks are padded to the full chunk width; wider than the KV
            # ring, the pad positions would alias real ring slots (the
            # attention layer rejects such chunks).  A prompt never exceeds
            # max_len (try_add validates), so clamping loses nothing.
            self.chunk = cap
        self.lanes = max(1, self.chunks_per_step)
        with self.split():
            self._axes = _batch_axes(self.model, self.max_len)
            self._lane_state = self.model.init_decode_state(
                self.lanes, self.max_len, device=self.device)
            self._fresh = self.model.init_decode_state(1, self.max_len,
                                                       device=self.device)

    def _extend_lanes(self, tokens, lengths, npl):
        with precision_scope(npl), self.split():
            return self.model.extend(self.params, self._lane_state, tokens,
                                     lengths=lengths)

    def _resolve_precision(self, req: "Request | None") -> int:
        """The request's plane budget as a python int; ``None`` (no request,
        or no explicit budget) is the layer default (``cfg.dslot.n_planes``,
        then ``n_bits``)."""
        d = self.model.cfg.dslot
        if req is not None and req.n_planes is not None:
            return int(req.n_planes)
        return int(d.n_planes or d.n_bits)

    # ------------------------------------------------------------- queue

    def __len__(self) -> int:
        """Admissions not yet decodable: queued + in-flight."""
        return len(self.queue) + len(self.active)

    def enqueue(self, req: "Request") -> bool:
        if self.max_queue is not None and len(self) >= self.max_queue:
            return False
        if (self.dslot and not self.calibrated
                and req.n_planes is not None
                and 0 < self.chunk < len(req.prompt)):
            # Chunked prefill quantizes each chunk's activations separately;
            # without a calibrated scale the per-call max makes the result
            # depend on where the prompt was split.  Refuse instead of
            # drifting.
            raise ValueError(
                f"request {req.uid}: a per-request DSLOT plane budget with "
                f"a chunked prompt ({len(req.prompt)} tokens > prefill_"
                f"chunk={self.chunk}) requires a calibrated activation "
                "scale — per-call max quantization is not chunk-invariant. "
                "Set DslotConfig.act_scale (or DslotWeights.with_scale), "
                "or use prefill_chunk=0")
        req.phase = PENDING
        self.queue.append(req)
        return True

    def cancel(self, uid: int) -> bool:
        """Drop a pending or in-flight admission.  The pool was never
        written, so only the task is discarded — its reserved slot is
        released, and its lane is reset when the next claimed request
        reuses it.  A cancelled request is terminal: ``done`` is set."""
        for req in self.queue:
            if req.uid == uid:
                self.queue.remove(req)
                req.phase = CANCELLED
                req.done = True
                return True
        for task in self.active:
            if task.req.uid == uid:
                task.req.phase = CANCELLED
                task.req.done = True
                self.active.remove(task)
                return True
        return False

    # ------------------------------------------------------------- stepping

    def tick(self, free_slot: Callable[[set], int | None]
             ) -> list[PrefillTask]:
        """Run one step's worth of admission work.

        ``free_slot(exclude)`` returns a claimable slot index not in
        ``exclude``, or None (pool full).  Returns the tasks whose last
        chunk landed this tick.  Claiming happens only at tick start, so
        admission can never double-book a slot completed within the tick.

        HYBRID schedule: claim queue heads into free (slot, lane) pairs up
        to ``chunks_per_step`` lanes, advance ALL active tasks by one chunk
        in a single stacked forward, then spend any leftover budget on
        extra chunks of the HEAD task (FIFO).
        """
        completed: list[PrefillTask] = []
        while self.queue and len(self.active) < self.lanes:
            slot = free_slot(set())
            if slot is None:
                break
            req = self.queue.popleft()
            req.phase = PREFILLING
            lane = min(set(range(self.lanes))
                       - {t.lane for t in self.active})
            # reset the lane: an empty ring at position 0 (a previous
            # occupant's keys would otherwise be causally visible)
            insert_row(self._lane_state, self._fresh, self._axes, lane)
            self.active.append(PrefillTask(req=req, slot=slot, lane=lane))
        budget = max(1, self.chunks_per_step)
        spent = 0
        while spent < budget and self.active:
            targets = list(self.active) if spent == 0 else [self.active[0]]
            completed.extend(self._forward_lanes(targets))
            spent += len(targets)
        return completed

    def _forward_lanes(self, targets: list[PrefillTask]
                       ) -> list[PrefillTask]:
        """Advance ``targets`` by one chunk in ONE stacked forward; returns
        the tasks whose prompt is now fully in (with a copy of their lane's
        rows).  Non-target lanes ride along with zero-length rows, which
        leave their lane state as it was."""
        L = self.lanes
        c = self.chunk if self.chunk > 0 \
            else max(t.remaining for t in targets)
        toks = np.zeros((L, c), np.int32)
        lens = np.zeros((L,), np.int32)
        npl = np.full((L,), self._resolve_precision(None), np.int32)
        for t in targets:
            end = min(t.offset + c, len(t.req.prompt))
            n = end - t.offset
            toks[t.lane, :n] = t.req.prompt[t.offset:end]
            lens[t.lane] = n
            npl[t.lane] = self._resolve_precision(t.req)
        if self.injector is not None:
            # fault hook: a raise here leaves the tick transactional — no
            # task offset moved and nothing written
            self.injector.raise_if("lane_forward")
        dev = self.device
        logits, self._lane_state = self._extend_lanes(
            torch.from_numpy(toks).to(dev), torch.from_numpy(lens).to(dev),
            torch.from_numpy(npl).to(dev))
        self.forwards += 1
        completed: list[PrefillTask] = []
        for t in targets:
            t.offset += int(lens[t.lane])
            t.chunks_done += 1
            if t.offset >= len(t.req.prompt):
                t.logits = logits[t.lane:t.lane + 1]
                t.state = extract_row(self._lane_state, self._axes, t.lane)
                self.active.remove(t)
                completed.append(t)
        return completed
