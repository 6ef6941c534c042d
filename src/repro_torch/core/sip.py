"""Stripes' bit-serial inner-product unit (SIP), the paper's baseline
(Figs. 10/11; port of ``repro.core.sip``).

LSB-first bit-serial multiply-accumulate: each cycle i ANDs input bit
``x_i`` with the parallel weight word, reduces the k*k partial products
through an adder tree, and shift-adds into an accumulator.  The result's
sign is known only after the final cycle, so no early termination is
possible.  The model is bit-exact int32 arithmetic and doubles as the
oracle for the online-arithmetic path: both dequantize to identical SOPs.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

__all__ = ["SIPSchedule", "sip_schedule", "sip_sop", "sip_sop_trace"]


class SIPSchedule(NamedTuple):
    n_bits: int            # serial input precision (cycles of bit feed)
    tree_stages: int       # ceil(log2(k*k)) CPA stages per cycle
    total_cycles: int      # cycles to a usable SOP (sign known only here)


def sip_schedule(k: int, n_bits: int = 8) -> SIPSchedule:
    # one bit per cycle; the reduction tree and accumulator are
    # combinational within the (long) cycle, the paper's eq. 8 path
    tree_stages = max(0, math.ceil(math.log2(k * k)))
    return SIPSchedule(n_bits=n_bits, tree_stages=tree_stages,
                       total_cycles=n_bits)


def _sip_cycles(x_q: torch.Tensor, w_q: torch.Tensor, n_bits: int):
    """Accumulator after each cycle: ``acc += sum_taps(bit_i(x) * w) << i``.
    ``torch.sum`` of int32 widens to int64, so each cycle's sum is cast back
    to int32 as the reference's ``jnp.sum`` keeps it."""
    x_q = torch.as_tensor(x_q).to(torch.int32)
    w_q = torch.as_tensor(w_q).to(device=x_q.device, dtype=torch.int32)
    acc = x_q.new_zeros(torch.broadcast_shapes(x_q.shape, w_q.shape)[1:])
    for i in range(n_bits):
        bit = (x_q >> i) & 1                       # serial LSB-first input bit
        pp = bit * w_q                             # AND array (PPG, Fig. 11a)
        sopp = pp.sum(dim=0).to(torch.int32)       # reduction tree
        acc = acc + (sopp << i)                    # shift-add accumulator
        yield acc


def sip_sop(x_q: torch.Tensor, w_q: torch.Tensor, n_bits: int = 8
            ) -> torch.Tensor:
    """Bit-exact SIP evaluation of ``sum_taps x*w`` on integer operands.

    ``x_q``: (taps, *batch) non-negative int32 (post-ReLU activations),
    ``w_q``: (taps, *bcast) signed int32 weights (parallel).  Returns the
    int32 SOP, identical to ``sum(x_q * w_q)``, evaluated serially.
    """
    acc = None
    for acc in _sip_cycles(x_q, w_q, n_bits):
        pass
    return acc


def sip_sop_trace(x_q: torch.Tensor, w_q: torch.Tensor, n_bits: int = 8
                  ) -> torch.Tensor:
    """Accumulator value after every cycle: shows why early negative
    detection fails for LSB-first arithmetic.  Returns (n_bits, *batch)
    int32."""
    return torch.stack(list(_sip_cycles(x_q, w_q, n_bits)))
