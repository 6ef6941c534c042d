"""The device trace of a run's window: every operation that ran on the
card, from ``torch.profiler`` (CUDA activity only, events kept in memory),
reduced to busy time, time by operation, and the idle gaps labelled by the
host span that was open when each began."""

from __future__ import annotations

import bisect
import time
from collections import defaultdict


NAME_CHARS = 160          # a kernel's name in the breakdown, cut to this


class Spans:
    """Host spans on ``time.time_ns``'s clock, the profiler's clock, at two
    levels: outer spans (an engine step, a ``generate`` call) and the inner
    spans inside them (its admission, its decode forward).  Spans of one
    level never overlap."""

    def __init__(self):
        self.levels: dict[bool, list[tuple[int, int, str]]] = {
            True: [], False: []}

    def wrap(self, fn, label: str, outer: bool = False):
        items = self.levels[outer]

        def timed(*a, **k):
            t0 = time.time_ns()
            try:
                return fn(*a, **k)
            finally:
                items.append((t0, time.time_ns(), label))
        return timed

    def label_at(self, t: int, default: str = "harness") -> str:
        """The label of the inner span open at ``t``, else the outer one's,
        else ``default``."""
        for outer in (False, True):
            items = self.levels[outer]
            i = bisect.bisect_right(items, (t, float("inf"), "")) - 1
            if i >= 0 and items[i][0] <= t < items[i][1]:
                return items[i][2]
        return default


class DeviceTrace:
    def __init__(self):
        self.prof = None
        self.events: list[tuple[str, int, int]] = []

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        if not torch.cuda.is_available():
            return
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()

    def stop(self) -> None:
        if self.prof is None:
            return
        import torch
        from torch.autograd import DeviceType
        torch.cuda.synchronize()
        self.prof.stop()
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0:
                self.events.append((e.name(), e.start_ns(),
                                    e.start_ns() + e.duration_ns()))
        self.prof = None

    def summary(self, w0: int, w1: int, spans: Spans) -> dict | None:
        """Busy and idle time of ``[w0, w1)`` (ns), seconds by operation
        and the idle gaps by host span; None when the trace holds no
        device operation."""
        ev = sorted((s, e, n) for n, s, e in self.events
                    if e > w0 and s < w1)
        if not ev:
            return None
        by_name: dict[str, float] = defaultdict(float)
        busy = 0
        cur0 = cur1 = None
        gaps = []
        for s, e, n in ev:
            s, e = max(s, w0), min(e, w1)
            by_name[n] += (e - s) / 1e9
            if cur1 is None or s > cur1:
                if cur1 is not None:
                    busy += cur1 - cur0
                    gaps.append((cur1, s))
                elif s > w0:
                    gaps.append((w0, s))
                cur0, cur1 = s, e
            else:
                cur1 = max(cur1, e)
        busy += cur1 - cur0
        if cur1 < w1:
            gaps.append((cur1, w1))
        idle: dict[str, float] = defaultdict(float)
        longest: dict[str, float] = defaultdict(float)
        for g0, g1 in gaps:
            lab = spans.label_at(g0)
            idle[lab] += (g1 - g0) / 1e9
            longest[lab] = max(longest[lab], (g1 - g0) / 1e9)
        ops = [[n[:NAME_CHARS], v] for n, v in
               sorted(by_name.items(), key=lambda kv: -kv[1])[:10]]
        idle_rows = [[f"{lab} (all gaps)", v] for lab, v in
                     sorted(idle.items(), key=lambda kv: -kv[1])]
        idle_rows += [[f"{lab} (longest gap)", v] for lab, v in
                      sorted(longest.items(), key=lambda kv: -kv[1])]
        return {"busy_s": busy / 1e9, "window_s": (w1 - w0) / 1e9,
                "by_name": dict(by_name), "device_ops": ops,
                "idle_gaps": idle_rows[:10]}
