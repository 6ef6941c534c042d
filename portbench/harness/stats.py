"""Percentiles and the window's accounting."""

from __future__ import annotations

import math
import statistics


def percentile(xs, p: float) -> float | None:
    """Nearest-rank percentile (the smallest value with at least ``p``% of
    the sample at or below it); None for an empty sample."""
    xs = sorted(xs)
    if not xs:
        return None
    return xs[max(0, math.ceil(p / 100.0 * len(xs)) - 1)]


def mean(xs) -> float | None:
    xs = list(xs)
    return statistics.fmean(xs) if xs else None


def median(xs) -> float | None:
    xs = list(xs)
    return statistics.median(xs) if xs else None
