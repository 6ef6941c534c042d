"""The one traffic generator: every mix is a data file of parameters.

Sizes and gaps are stratified: each block of ``BLOCK`` requests holds the
same quantiles of the mix's distributions, shuffled inside the block, so
every seed offers the same work at the same rate.  The seed draws the
token ids.  In a closed loop it also shuffles the sizes; an open loop's
schedule (sizes and gaps in their order) is the mix's own, the same for
every seed: near the knee the order of arrivals sets the queue's course,
so runs of different orders differ far more than runs of one order.
"""

from __future__ import annotations

import math

import numpy as np


def _quantile(dist: dict, u: np.ndarray) -> np.ndarray:
    lo, hi = int(dist["lo"]), int(dist["hi"])
    if dist["dist"] == "loguniform":
        v = np.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))
        return np.clip(np.rint(v), lo, hi).astype(np.int64)
    if dist["dist"] == "uniform":
        return np.minimum(lo + np.floor(u * (hi - lo + 1)), hi).astype(
            np.int64)
    raise ValueError(f"unknown distribution {dist['dist']!r}")


def stratified(dist: dict, n: int, block: int, rng) -> np.ndarray:
    """``n`` draws: each block of ``block`` the same quantiles, shuffled."""
    u = (np.arange(block) + 0.5) / block
    base = _quantile(dist, u)
    out = [rng.permutation(base) for _ in range(-(-n // block))]
    return np.concatenate(out)[:n]


def gaps(rate: float, n: int, block: int, rng) -> np.ndarray:
    """Poisson inter-arrival gaps, stratified: each block's gaps are the
    exponential quantiles scaled to the block's exact mean ``1 / rate``."""
    u = (np.arange(block) + 0.5) / block
    base = -np.log1p(-u)
    base *= block / rate / base.sum()
    return np.concatenate([rng.permutation(base)
                           for _ in range(-(-n // block))])[:n]


def _rngs(seed: int):
    ss = np.random.SeedSequence(int(seed))
    return [np.random.default_rng(s) for s in ss.spawn(4)]


OPEN_ORDER = 0x0DE7      # the seed of every open loop's schedule
BLOCK = 64               # requests a stratified block holds


def requests(mix: dict, seed: int, n: int, vocab: int) -> list[dict]:
    """``n`` request specs in the order they are sent: ``prompt`` (int32
    ids), ``max_new``; an open loop adds ``due`` (seconds from the start of
    the traffic)."""
    r_size, r_out, _, r_gap = _rngs(OPEN_ORDER if mix["loop"] == "open"
                                    else seed)
    r_tok = _rngs(seed)[2]
    plens = stratified(mix["prompt"], n, BLOCK, r_size)
    outs = stratified(mix["output"], n, BLOCK, r_out)
    specs = [dict(uid=i, prompt=r_tok.integers(0, vocab, int(plens[i]))
                  .astype(np.int32), max_new=int(outs[i]))
             for i in range(n)]
    if mix["loop"] == "open":
        due = np.cumsum(gaps(float(mix["rate_per_s"]), n, BLOCK, r_gap))
        for s, t in zip(specs, due):
            s["due"] = float(t)
    elif mix.get("stagger"):
        # a closed loop's first request of each client is cut to a share of
        # its output, spread evenly over the clients, so completions are
        # spread from the start as in a loop that has run for a while
        c = int(mix["clients"])
        share = (r_gap.permutation(c) + 0.5) / c
        for s, f in zip(specs[:c], share):
            s["max_new"] = max(1, int(math.ceil(s["max_new"] * f)))
    return specs


def open_count(mix: dict, horizon_s: float) -> int:
    """Requests an open loop needs to cover ``horizon_s`` seconds."""
    return int(math.ceil(float(mix["rate_per_s"]) * horizon_s * 1.25)) + 64
