"""Helpers the metric readers share: they read a run's record (what the
driver returns) and return a number, or None where the run has nothing to
read."""

from __future__ import annotations

from portbench.harness import flops
from portbench.harness.stats import mean, median, percentile

def ttft_ms(rec: dict) -> list[float]:
    """Time to first token of every request whose first token lands in the
    window, from when it was due (open loop) or sent (closed loop)."""
    w0, w1 = rec["window"]
    return [(r["stamps"][0] - r["t_ref"]) * 1e3
            for r in rec.get("requests", ())
            if r.get("stamps") and w0 <= r["stamps"][0] < w1]


def itl_ms(rec: dict) -> list[float]:
    """Every gap between consecutive tokens of a request that ends in the
    window."""
    w0, w1 = rec["window"]
    out = []
    for r in rec.get("requests", ()):
        st = r.get("stamps") or []
        out += [(b - a) * 1e3 for a, b in zip(st, st[1:]) if w0 <= b < w1]
    return out


def p95(xs):
    return percentile(xs, 95.0)


def window_tokens(rec: dict) -> int:
    if rec["kind"] == "batch":
        return sum(b["tokens"] for b in rec["batches"])
    w0, w1 = rec["window"]
    return sum(1 for r in rec["requests"] for t in r["stamps"]
               if w0 <= t < w1)


def trace_window_s(rec: dict) -> float:
    t0, t1 = rec["trace_window"]
    return t1 - t0


def total_flops(rec: dict) -> float:
    if rec["kind"] == "batch":
        return sum(b["flops"] for b in rec["batches"])
    return sum(s["flops"] for s in rec["steps"])


def mfu_pct(f: float, seconds: float) -> float | None:
    if seconds <= 0 or f <= 0:
        return None
    return 100.0 * f / (seconds * flops.PEAK_BF16_FLOPS)


def admit_steps(rec: dict) -> list[dict]:
    return [s for s in rec.get("steps", ()) if s["admit"]]


def dslot_roofline_pct(rec: dict, names: tuple[str, ...]) -> float | None:
    """The summed least time of the window's DSLOT calls over the device
    time of the kernels named ``names``, in percent."""
    tr = rec.get("trace")
    if not tr:
        return None
    spent = sum(s for n, s in tr["by_name"].items()
                if any(k in n for k in names))
    if spent <= 0:
        return None
    least = sum(c * flops.dslot_least_s(int(round(M)), K, N, rec["w_bytes"])
                for M, K, N, c in rec["dslot_calls"])
    return 100.0 * least / spent


def idle_pct(rec: dict) -> float | None:
    tr = rec.get("trace")
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def planes_mean(rec: dict) -> float | None:
    vals = [r["planes"] for r in rec.get("requests", ())
            if r.get("planes") is not None
            and (rec["kind"] == "batch" or (
                r.get("end") is not None
                and rec["window"][0] <= r["end"] < rec["window"][1]))]
    return sum(vals) / len(vals) if vals else None


__all__ = ["admit_steps", "dslot_roofline_pct", "idle_pct",
           "itl_ms", "mean", "median", "mfu_pct", "p95", "percentile",
           "planes_mean", "total_flops", "trace_window_s", "ttft_ms",
           "window_tokens"]
