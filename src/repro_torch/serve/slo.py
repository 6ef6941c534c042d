"""SLO-aware precision-elastic control: trade digit planes for latency
(port of ``repro.serve.slo``).

The paper's headline property — precision tunable at run time — lets this
serving stack do something no fixed-precision engine can: when load spikes,
*shed digit planes* instead of letting the queue blow up, and restore them
when the burst drains.  Because ``n_planes`` is a runtime value that
reaches the kernel in device memory (no rebuild — see ``kernels/ops.py``),
the controller can move per-slot budgets every engine step for free.

:class:`SloController` closes that loop on load.  Each engine step it
ingests a :class:`SloSignals` snapshot (admission queue depth, the TTFTs of
requests that just produced their first token, whether the step carried
admission work, pooled planes-used) and maintains one *plane level* per QoS
tier.  ``ServeEngine._budget_vector`` then clamps every slot's granted
budget to its tier's current level, so shedding reaches the very next
pooled decode step.

QoS tiers (``Request.tier``):

* ``"reserved"`` — floor pinned at full precision (``n_bits``): never shed.
  The paid tier; the controller may raise a lower explicit budget to the
  floor.
* ``"standard"`` — full elastic range; shed only after degradable is at its
  floor.
* ``"degradable"`` — shed first, down to a 1-plane floor.  The free tier.

Control law (plain python, runs on the host between steps, like the
``repro_torch.runtime`` policies):

* *pressure* when the queue is deeper than ``queue_high_water`` OR the
  rolling-window p95 TTFT (engine-steps domain) exceeds
  ``target_ttft_steps`` OR any request was deadline-evicted this step
  (``SloSignals.timed_out`` — a missed deadline is direct overload
  evidence, so it feeds shed decisions immediately);
* *slack* when the queue is empty, the window p95 is within target, and
  nothing timed out;
* **hysteresis**: shedding requires ``shed_patience`` consecutive pressure
  steps, restoring requires ``restore_patience`` consecutive slack steps,
  and any neutral step resets both counters — so budgets cannot oscillate
  on a boundary load.
* shed order: degradable -> standard -> (reserved only if its spec allows),
  one ``shed_step`` at a time; restore runs in the reverse order, so the
  most important tier recovers first.

The controller reuses :class:`repro_torch.runtime.PolicyFeedback` for the
per-request planes-executed account the engine already produces: ``observe``
keeps a per-tier EMA of the planes actually used, the accuracy side of the
latency/accuracy trade.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Iterable, Mapping

from repro_torch.runtime.policy import PolicyFeedback

__all__ = ["RESERVED", "STANDARD", "DEGRADABLE", "TIERS", "TierSpec",
           "default_tiers", "SloConfig", "SloSignals", "SloController"]

# QoS tier names (``Request.tier``).
RESERVED = "reserved"        # floor at full precision — never shed
STANDARD = "standard"        # full elastic range — shed after degradable
DEGRADABLE = "degradable"    # shed first, deepest floor
TIERS = (RESERVED, STANDARD, DEGRADABLE)


@dataclasses.dataclass(frozen=True)
class TierSpec:
    """Plane floor/ceiling of one QoS tier, and where it sits in the shed
    order (lower ``shed_order`` sheds first)."""
    floor: int
    ceiling: int
    shed_order: int

    def clamp(self, n_planes: int, level: int) -> int:
        """Effective budget: granted ``n_planes`` capped by the controller
        ``level``, never below the tier floor."""
        return max(self.floor, min(int(n_planes), level))


def default_tiers(n_bits: int) -> dict[str, TierSpec]:
    """The stock three-tier table at a given digit width."""
    return {
        RESERVED: TierSpec(floor=n_bits, ceiling=n_bits, shed_order=2),
        STANDARD: TierSpec(floor=min(2, n_bits), ceiling=n_bits,
                           shed_order=1),
        DEGRADABLE: TierSpec(floor=1, ceiling=n_bits, shed_order=0),
    }


@dataclasses.dataclass(frozen=True)
class SloConfig:
    """Knobs of the SLO control loop (``ServeConfig.slo``).

    target_ttft_steps: p95 TTFT target, in ENGINE STEPS — the deterministic
        clock ``Request.ttft_steps`` is measured in (wall-clock targets
        would make the control law depend on host speed).
    queue_high_water: admission-queue depth treated as overload pressure.
    ttft_window: rolling window (samples) the p95 is computed over.
    shed_patience / restore_patience: consecutive pressure / slack steps
        required before acting — the hysteresis that stops oscillation.
        Restoring should be the slower of the two.
    shed_step / restore_step: planes moved per action.
    ttft_idle_expiry: consecutive idle updates (empty queue, no new first
        tokens) after which the rolling TTFT window is cleared.  Without
        this, the p95 of a fully-drained burst would read "hot" forever —
        no new arrivals means no new samples to roll the stale ones out —
        and budgets would never restore.
    tiers: override the ``default_tiers`` table (floors/ceilings are
        clamped to [1, n_bits] at controller construction).
    """
    target_ttft_steps: int = 8
    queue_high_water: int = 4
    ttft_window: int = 32
    shed_patience: int = 2
    restore_patience: int = 4
    shed_step: int = 1
    restore_step: int = 1
    ttft_idle_expiry: int = 8
    tiers: Mapping[str, TierSpec] | None = None


@dataclasses.dataclass
class SloSignals:
    """One engine step's load snapshot, fed to ``SloController.update``."""
    queue_depth: int                       # pending + prefilling requests
    ttft_steps: list[int] = dataclasses.field(default_factory=list)
    decode_stalled: bool = False           # step carried admission work
    planes_used_mean: float | None = None  # pooled per-row planes this step
    timed_out: int = 0                     # deadline evictions this step —
                                           # missed deadlines are the most
                                           # direct overload evidence there
                                           # is, so any count is pressure


class SloController:
    """Per-tier plane levels driven by load, with hysteresis.

    The engine owns exactly one controller (``ServeEngine.slo``) and calls
    ``update`` once per step before building the slot budget vector;
    ``budget_for`` maps a request's granted budget through its tier's
    current level.  All state is plain python on the host.
    """

    def __init__(self, n_bits: int, cfg: SloConfig | None = None):
        self.cfg = cfg or SloConfig()
        self.n_bits = int(n_bits)
        tiers = dict(self.cfg.tiers) if self.cfg.tiers is not None \
            else default_tiers(self.n_bits)
        self.tiers: dict[str, TierSpec] = {
            name: TierSpec(floor=max(1, min(t.floor, self.n_bits)),
                           ceiling=max(1, min(t.ceiling, self.n_bits)),
                           shed_order=t.shed_order)
            for name, t in tiers.items()}
        # current allowance per tier; starts fully restored
        self.levels: dict[str, int] = {n: t.ceiling
                                       for n, t in self.tiers.items()}
        self.min_levels: dict[str, int] = dict(self.levels)
        self.shed_events = 0
        self.restore_events = 0
        self.steps = 0
        self.planes_used_ema: dict[str, float] = {}
        self._ttfts: deque[int] = deque(maxlen=self.cfg.ttft_window)
        self._hot = 0
        self._cool = 0
        self._idle = 0

    # ------------------------------------------------------------- queries

    def budget_for(self, tier: str, n_planes: int) -> int:
        """Effective plane budget for a slot: granted budget through the
        tier's floor/ceiling and current shed level."""
        spec = self.tiers[tier]
        return spec.clamp(n_planes, self.levels[tier])

    def floor(self, tier: str) -> int:
        return self.tiers[tier].floor

    def ttft_p95(self) -> float | None:
        """Rolling-window p95 TTFT (engine steps), None before any sample."""
        if not self._ttfts:
            return None
        xs = sorted(self._ttfts)
        return float(xs[min(len(xs) - 1, int(0.95 * (len(xs) - 1) + 0.5))])

    # ------------------------------------------------------------- control

    def update(self, sig: SloSignals) -> dict[str, int]:
        """Ingest one step's signals; returns the (possibly moved) levels."""
        self.steps += 1
        if sig.ttft_steps:
            self._ttfts.extend(int(t) for t in sig.ttft_steps)
            self._idle = 0
        elif sig.queue_depth == 0:
            # idle expiry: a drained burst's TTFTs stop describing current
            # load once nothing has arrived for a while (see SloConfig)
            self._idle += 1
            if self._idle >= self.cfg.ttft_idle_expiry:
                self._ttfts.clear()
        else:
            self._idle = 0
        p95 = self.ttft_p95()
        ttft_hot = p95 is not None and p95 > self.cfg.target_ttft_steps
        ttft_ok = p95 is None or p95 <= self.cfg.target_ttft_steps
        pressure = (sig.queue_depth > self.cfg.queue_high_water or ttft_hot
                    or sig.timed_out > 0)
        slack = sig.queue_depth == 0 and ttft_ok and sig.timed_out == 0
        if pressure:
            self._hot += 1
            self._cool = 0
        elif slack:
            self._cool += 1
            self._hot = 0
        else:                       # neutral: hysteresis counters reset
            self._hot = 0
            self._cool = 0
        if self._hot >= self.cfg.shed_patience:
            self._shed()
            self._hot = 0
        if self._cool >= self.cfg.restore_patience:
            self._restore()
            self._cool = 0
        for n, lv in self.levels.items():
            self.min_levels[n] = min(self.min_levels[n], lv)
        return dict(self.levels)

    def _order(self, reverse: bool = False) -> Iterable[str]:
        return sorted(self.tiers, key=lambda n: self.tiers[n].shed_order,
                      reverse=reverse)

    def _shed(self) -> bool:
        """Drop one tier by ``shed_step`` planes: the lowest-priority tier
        still above its floor.  Reserved (floor == ceiling) never moves."""
        for name in self._order():
            spec = self.tiers[name]
            if self.levels[name] > spec.floor:
                self.levels[name] = max(spec.floor,
                                        self.levels[name]
                                        - self.cfg.shed_step)
                self.shed_events += 1
                return True
        return False

    def _restore(self) -> bool:
        """Raise one tier by ``restore_step`` planes — reverse shed order,
        so the most important degraded tier recovers first."""
        for name in self._order(reverse=True):
            spec = self.tiers[name]
            if self.levels[name] < spec.ceiling:
                self.levels[name] = min(spec.ceiling,
                                        self.levels[name]
                                        + self.cfg.restore_step)
                self.restore_events += 1
                return True
        return False

    # ------------------------------------------------------------ feedback

    def observe(self, fb: PolicyFeedback) -> None:
        """Per-request planes-executed account (the same ``PolicyFeedback``
        the ``repro_torch.runtime`` policies consume): per-tier EMA of the
        planes actually used — the accuracy side of the latency/accuracy
        trade."""
        tier = fb.tier or STANDARD
        prev = self.planes_used_ema.get(tier)
        val = float(fb.planes_used_mean)
        self.planes_used_ema[tier] = val if prev is None \
            else 0.7 * prev + 0.3 * val

    def summary(self) -> dict:
        """JSON-ready controller account (benchmark / observability)."""
        return {
            "levels": dict(self.levels),
            "min_levels": dict(self.min_levels),
            "shed_events": self.shed_events,
            "restore_events": self.restore_events,
            "ttft_p95_steps": self.ttft_p95(),
            "planes_used_ema": {k: round(v, 3)
                                for k, v in self.planes_used_ema.items()},
        }
