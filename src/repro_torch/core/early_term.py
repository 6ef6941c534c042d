"""Early detection and termination of negative activations (paper
Algorithm 1; port of ``repro.core.early_term``).

The ReLU unit accumulates the SOP's redundant output digits and terminates
the PE as soon as the prefix value goes negative (``z+[j] < z-[j]``).  MSDF
emission makes this sound: once negative, the remaining digits cannot
restore positivity, so the remaining cycles are skipped.  This module
evaluates Algorithm 1 over batches of SOP digit streams and returns per-SOP
cycle accounting against the PE schedule (eq. 6): the data behind the
paper's Fig. 8 (negative-activation rates) and Fig. 9 (cycle savings).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .digits import first_negative_prefix, sd_prefix_values
from .pe import PESchedule

__all__ = ["TerminationReport", "early_termination"]


class TerminationReport(NamedTuple):
    """Per-SOP outcome of Algorithm 1 (leading axes = batch of SOPs)."""
    is_negative: torch.Tensor     # bool: the termination signal fired
    term_digit: torch.Tensor      # int32: 1-based firing digit (p_out+1 if never)
    cycles_used: torch.Tensor     # int32: hardware cycles spent (eq. 6 schedule)
    cycles_full: int              # cycles without early termination
    cycles_saved: torch.Tensor    # int32: cycles_full - cycles_used
    savings_frac: torch.Tensor    # float32: cycles_saved / cycles_full

    @property
    def negative_rate(self) -> torch.Tensor:
        return self.is_negative.to(torch.float32).mean()

    @property
    def mean_savings(self) -> torch.Tensor:
        return self.savings_frac.mean()


def early_termination(sop_digits: torch.Tensor, schedule: PESchedule
                      ) -> TerminationReport:
    """Apply Algorithm 1 to SOP digit streams ``(p_out, *batch)``.

    A PE that never fires runs ``schedule.total_cycles``; one that fires at
    digit j stops at cycle ``pipeline_fill + j`` (the comparator sits on the
    output digits, so the fill cycles are always paid).
    """
    p_out = sop_digits.shape[0]
    term = first_negative_prefix(sop_digits)        # (batch,), p_out+1 if none
    fired = term <= p_out
    full = int(schedule.total_cycles)
    used = torch.where(fired, schedule.pipeline_fill + term,
                       torch.full_like(term, full))
    saved = full - used
    return TerminationReport(
        is_negative=fired,
        term_digit=term,
        cycles_used=used,
        cycles_full=full,
        cycles_saved=saved,
        savings_frac=saved.to(torch.float32) / float(full),
    )


def prefix_sign_trace(sop_digits: torch.Tensor) -> torch.Tensor:
    """Sign of every prefix value: the comparator's input, for diagnosis."""
    return torch.sign(sd_prefix_values(sop_digits))
