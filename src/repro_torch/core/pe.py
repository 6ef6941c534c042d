"""DSLOT-NN processing engine (paper Fig. 3) and its cycle schedule (eq. 6)
(port of ``repro.core.pe``).

A PE holds ``k*k`` serial-parallel online multipliers (weights parallel,
activations digit-serial) feeding a digit-pipelined reduction tree of online
adders; it emits the window's SOP digit stream MSDF.  Every tree stage
scales by 1/2, so a PE with S tree stages emits ``SOP / 2^S``
(``pe_output_scale``).  The schedule is analytic:

    Num_cycles = delta_x + delta_+ * ceil(log2(k*k))
               + delta_+ * ceil(log2(N)) + p_out                    (eq. 6)
    p_out      = p_mult + ceil(log2(k*k))                           (eq. 7)

so SOP digit j is available at cycle ``pipeline_fill + j``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .online import DELTA_ADD, DELTA_MULT, online_add_tree, online_mult_sp

__all__ = ["PESchedule", "pe_schedule", "pe_sop_digits", "pe_output_scale"]


class PESchedule(NamedTuple):
    """Analytic timing of one PE evaluation (all counts in cycles)."""
    delta_mult: int
    delta_add: int
    tree_stages: int       # ceil(log2(k*k))
    fmap_stages: int       # ceil(log2(N)): cross-feature-map reduction
    p_mult: int            # product digits emitted by each OLM
    p_out: int             # SOP digits (eq. 7)
    pipeline_fill: int     # cycles before the first SOP digit appears
    total_cycles: int      # eq. 6

    def cycle_of_digit(self, j: torch.Tensor | int) -> torch.Tensor | int:
        """Hardware cycle at which SOP digit j (1-based) is available."""
        return self.pipeline_fill + j


def pe_schedule(k: int, n_fmaps: int = 1, p_mult: int = 16,
                delta_mult: int = DELTA_MULT, delta_add: int = DELTA_ADD
                ) -> PESchedule:
    """Paper eq. 6/7.  Defaults give the paper's 33-cycle example:
    k=5, N=1, p_mult=16 -> p_out=21, Num_cycles=33."""
    tree_stages = max(0, math.ceil(math.log2(k * k)))
    fmap_stages = max(0, math.ceil(math.log2(n_fmaps))) if n_fmaps > 1 else 0
    p_out = p_mult + tree_stages
    fill = delta_mult + delta_add * tree_stages + delta_add * fmap_stages
    return PESchedule(delta_mult=delta_mult, delta_add=delta_add,
                      tree_stages=tree_stages, fmap_stages=fmap_stages,
                      p_mult=p_mult, p_out=p_out, pipeline_fill=fill,
                      total_cycles=fill + p_out)


def pe_output_scale(schedule: PESchedule) -> float:
    """SOP = emitted_value * 2^(tree_stages + fmap_stages)."""
    return float(2 ** (schedule.tree_stages + schedule.fmap_stages))


def pe_sop_digits(x_digits: torch.Tensor, w_frac: torch.Tensor,
                  schedule: PESchedule) -> torch.Tensor:
    """Run one PE: ``k*k`` OLMs + the online-adder tree, vectorized.

    ``x_digits``: (n_in_digits, taps, *batch) SD streams, the window's
        activations digit-serial (taps = k*k, or k*k*N with the
        feature-map reduction folded into the same tree).
    ``w_frac``:   (taps, *batch-broadcastable) parallel weight fractions,
        ``|w| < 1`` (the stationary operand of the serial-parallel OLM).

    Returns the SOP digit stream ``(p_out, *batch)`` representing
    ``sum_taps(x*w) / 2^stages`` MSDF.
    """
    prods = online_mult_sp(x_digits, w_frac, n_out=schedule.p_mult,
                           delta=schedule.delta_mult)   # (p_mult, taps, ...)
    sop, stages = online_add_tree(prods.movedim(1, 0), n_out=schedule.p_out,
                                  delta=schedule.delta_add)
    expected = schedule.tree_stages + schedule.fmap_stages
    if stages > expected:
        raise ValueError(f"tree deeper than schedule: {stages} > {expected}")
    return sop
