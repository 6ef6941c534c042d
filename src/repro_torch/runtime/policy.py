"""Precision policies: who decides how many digit planes a request runs
(port of ``repro.runtime.policy``).

A policy is consulted when a request is admitted (``next_precision``) and
fed the observed execution statistics when it finishes (``observe``).
Three implementations:

* :class:`Fixed` — every request at one precision (the paper's static knob).
* :class:`PerLayerSchedule` — a per-layer plane budget (early CNN layers are
  precision-sensitive, logit heads are not); yields the dict form consumed
  by ``precision_scope``.
* :class:`AdaptiveBudget` — closes the loop on the engine's
  ``planes_used`` / ``skipped_frac`` feedback: keeps an EMA of the effective
  planes actually executed per output and picks the next request's precision
  so that estimated work stays under an average plane budget (the software
  analogue of running the accelerator inside a power envelope).

Policies are plain python state machines: they run outside the model code,
between engine steps, and only ever hand integers (or dicts of integers) to
the layers through ``precision_scope``.  ``repro_torch.serve.ServeEngine``
consults them at enqueue and feeds them each request's account on finish.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Protocol


@dataclasses.dataclass
class PolicyFeedback:
    """One execution's observed statistics, fed back to the policy.

    ``tier`` carries a request's QoS tier for serving callers and is
    ``None`` elsewhere.
    """
    n_planes: int                   # precision the request ran at
    planes_used_mean: float         # effective planes per output row
    skipped_frac: float             # fraction of plane budget skipped
    tier: str | None = None         # QoS tier (serving engine fills this)


class PrecisionPolicy(Protocol):
    def next_precision(self) -> Any:
        """Precision for the next admitted request: int or per-layer dict."""
        ...

    def observe(self, fb: PolicyFeedback) -> None:
        """Feed back observed statistics (no-op for static policies)."""
        ...


@dataclasses.dataclass
class Fixed:
    """Every request at ``n_planes`` digit planes."""
    n_planes: int = 8

    def next_precision(self) -> int:
        return self.n_planes

    def observe(self, fb: PolicyFeedback) -> None:
        pass


@dataclasses.dataclass
class PerLayerSchedule:
    """Static per-layer plane budgets, e.g. ``{"conv1": 8, "dense1": 4}``.

    ``default`` applies to layers not named in the schedule (the ``"*"``
    entry of the precision-scope dict form).
    """
    schedule: dict[str, int]
    default: int | None = None

    def next_precision(self) -> dict[str, int]:
        out = dict(self.schedule)
        if self.default is not None:
            out["*"] = self.default
        return out

    def observe(self, fb: PolicyFeedback) -> None:
        pass


@dataclasses.dataclass
class AdaptiveBudget:
    """Pick each request's precision to hold average executed planes at or
    under ``plane_budget`` (an energy proxy: one plane == one MXU pass per
    tile == one OLM digit cycle in the paper's datapath).

    The engine reports the effective planes per output row it actually
    executed (``planes_used_mean``); early termination means a request run
    at precision D typically costs less than D.  We track an EMA of the
    cost-per-granted-plane ratio and grant the largest precision whose
    predicted cost fits the budget — so workloads with many ReLU-dead
    outputs automatically earn higher precision, and dense workloads are
    throttled, without ever retracing (precision is a runtime argument).
    """
    plane_budget: float = 5.0
    min_planes: int = 2
    max_planes: int = 8
    ema: float = 0.3                 # feedback smoothing
    # cost_ratio: observed executed-planes per granted plane, EMA'd.
    cost_ratio: float = 1.0
    last_feedback: PolicyFeedback | None = None

    def next_precision(self) -> int:
        # largest D with predicted cost D * cost_ratio <= budget
        d = int(self.plane_budget / max(self.cost_ratio, 1e-6))
        return max(self.min_planes, min(self.max_planes, d))

    def observe(self, fb: PolicyFeedback) -> None:
        self.last_feedback = fb
        if fb.n_planes <= 0:
            return
        ratio = fb.planes_used_mean / fb.n_planes
        ratio = min(max(ratio, 0.0), 1.0)
        self.cost_ratio = (1 - self.ema) * self.cost_ratio + self.ema * ratio
