"""Fault-tolerant training loop: checkpoint/restart, failure injection,
straggler detection, elastic mesh downsize (port of
``repro.distributed.fault_tolerance``).

* ``ResilientTrainer`` — wraps a train loop with periodic async
  checkpoints, catches injected ``NodeFailure``s, restores the last
  committed state (crc checked) and continues; on a topology change it
  rebuilds the mesh and restores the state resharded onto it (elastic
  restart).
* ``StragglerMonitor`` — EWMA + p95 watchdog over per-step times; flags
  persistent outliers for re-dispatch.
* ``HeartbeatTracker`` — deadline-based failure detector for the
  controller.

The loop is the reference's.  It runs SPMD on every rank of a
``torch.distributed`` world: a failure is injected on every rank at the
same step, every rank rebuilds (building a mesh over some ranks is
collective over the whole world), and the survivors are the first
``world - lost`` ranks; a rank left out returns from ``run`` with the state
``None``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import numpy as np

from repro_torch.checkpoint.checkpointer import Checkpointer

__all__ = ["HeartbeatTracker", "NodeFailure", "ResilientTrainer",
           "StragglerMonitor", "TrainerReport"]


class NodeFailure(RuntimeError):
    """Injected/observed loss of a worker."""

    def __init__(self, msg: str, lost_nodes: int = 1):
        super().__init__(msg)
        self.lost_nodes = lost_nodes


@dataclass
class HeartbeatTracker:
    deadline_s: float = 10.0
    last_seen: dict = field(default_factory=dict)

    def beat(self, node: int, now: float) -> None:
        self.last_seen[node] = now

    def dead_nodes(self, now: float) -> list[int]:
        return [n for n, t in self.last_seen.items()
                if now - t > self.deadline_s]


class StragglerMonitor:
    """Flags ranks whose step time exceeds ``factor`` x the fleet p95."""

    def __init__(self, n_ranks: int, factor: float = 1.5,
                 patience: int = 3, ewma: float = 0.3):
        self.n = n_ranks
        self.factor = factor
        self.patience = patience
        self.ewma = ewma
        self.mean = np.zeros(n_ranks)
        self.strikes = np.zeros(n_ranks, np.int64)

    def observe(self, step_times: np.ndarray) -> list[int]:
        """step_times: (n_ranks,) seconds.  Returns ranks to re-dispatch."""
        self.mean = (1 - self.ewma) * self.mean + self.ewma * step_times
        p95 = np.percentile(self.mean, 95)
        slow = self.mean > self.factor * max(p95, 1e-9)
        self.strikes = np.where(slow, self.strikes + 1, 0)
        return [int(r) for r in np.nonzero(self.strikes >= self.patience)[0]]


@dataclass
class TrainerReport:
    steps_done: int
    restarts: int
    reshards: int
    losses: list
    flagged_stragglers: list


class ResilientTrainer:
    """Checkpointed, restartable step loop.

    ``make_mesh_and_step(n_lost)`` builds ``(mesh, shardings, step_fn,
    place)`` for the surviving topology and is called on every rank of the
    world: once at start and again after every failure (``n_lost``
    accumulates), which is where elastic downsizing happens.  It returns
    None on a rank left out of the topology, and mesh and shardings None
    for a run without a world.  ``shardings`` (a
    ``train.sharding.Shardings`` of the state) goes to every save and
    restore.  ``inject`` maps step -> NodeFailure for tests.
    """

    def __init__(self, *, checkpointer: Checkpointer,
                 make_mesh_and_step: Callable,
                 ckpt_every: int = 10):
        self.ck = checkpointer
        self.make = make_mesh_and_step
        self.ckpt_every = ckpt_every

    def run(self, state, data_iter, n_steps: int,
            inject: dict | None = None) -> tuple[object, TrainerReport]:
        inject = inject or {}
        restarts = reshards = 0
        lost = 0
        losses: list[float] = []
        flagged: list[int] = []

        mesh, shardings, step_fn, place = self.make(lost)
        step = int(state.step)
        self.ck.save(step, state, shardings)

        while step < n_steps:
            try:
                if step in inject:
                    failure = inject.pop(step)
                    raise failure
                batch = data_iter(step)
                state, metrics = step_fn(state, place(batch))
                losses.append(float(metrics["loss"]))
                step += 1
                if step % self.ckpt_every == 0:
                    self.ck.wait()
                    self.ck.save_async(step, state, shardings)
            except NodeFailure as e:
                restarts += 1
                lost += e.lost_nodes
                self.ck.wait()
                # rebuild on the surviving topology, restore, reshard
                built = self.make(lost)
                reshards += 1 if e.lost_nodes else 0
                if built is None:       # this rank is not a survivor
                    state = None
                    break
                mesh, shardings, step_fn, place = built
                restore_step = self.ck.latest_step()
                state = self.ck.restore(restore_step, state, shardings)
                step = int(restore_step)
        self.ck.wait()
        return state, TrainerReport(steps_done=step, restarts=restarts,
                                    reshards=reshards, losses=losses,
                                    flagged_stragglers=flagged)
