"""Online (MSDF) arithmetic operators: serial-parallel multiplier and adder
(port of ``repro.core.online``).

* ``online_mult_sp``: the serial-parallel online multiplier (paper Fig. 2a):
  serial SD input ``x`` digit by digit MSDF, parallel constant operand
  ``Y``; output digits MSDF after an online delay ``delta = 2``.
* ``online_add``: the digit-serial online adder (paper Fig. 2b): both
  inputs and the output are SD MSDF streams, ``delta = 2``.  It emits the
  *scaled* sum ``(a + b) / 2`` (the paper's ``p_out`` bit-growth
  bookkeeping, eq. 7), so a depth-S reduction tree yields ``sum / 2^S``.

Both are instances of one recurrence on the scaled residual,

    W[t] = 2 W[t-1] + u_t 2^{-delta} - z_{t-delta},
    z_j  = 0 if |v| < 1/2 else sign(v)   (exact-residual selection),

which keeps ``|W| <= 3/4`` for the operand bounds used here.  Every residual
is an exact dyadic value in float32, so the digits equal the reference's;
each step keeps the reference's order, ``2.0 * w + u_t * scale``, as
separate operations.
"""

from __future__ import annotations

import torch

from .digits import _select

__all__ = ["online_emit", "online_mult_sp", "online_add", "online_add_tree",
           "DELTA_MULT", "DELTA_ADD"]

DELTA_MULT = 2  # paper §II-A.1: delta_x = 2
DELTA_ADD = 2   # paper §II-A.2: delta_+ = 2


def online_emit(u_stream: torch.Tensor, n_out: int, delta: int
                ) -> torch.Tensor:
    """Generic MSDF digit emission.

    ``u_stream``: (T, *batch) float32, the per-cycle value increments; the
    represented value is ``sum_t u_t 2^-t``.  Emits ``n_out`` SD digits with
    online delay ``delta``: cycle t consumes ``u_t`` (zero once exhausted)
    and, for ``t > delta``, emits digit ``z_{t-delta}``.

    Requires ``|u_t| <= 1`` and a total-value bound < 1 (callers guarantee
    this).  Returns (n_out, *batch) int8.
    """
    T = u_stream.shape[0]
    total = n_out + delta
    if T > total:
        raise ValueError(f"u_stream longer ({T}) than n_out+delta ({total})")
    scale = 2.0 ** (-delta)
    w = u_stream.new_zeros(u_stream.shape[1:], dtype=torch.float32)
    zero = torch.zeros_like(w)
    digits = []
    for t in range(total):
        u_t = u_stream[t] if t < T else zero
        v = 2.0 * w + u_t * scale
        if t < delta:               # the first `delta` cycles only accumulate
            w = v
            continue
        z = _select(v)
        w = v - z.to(torch.float32)
        digits.append(z)
    return torch.stack(digits)


def online_mult_sp(x_digits: torch.Tensor, y: torch.Tensor, n_out: int,
                   delta: int = DELTA_MULT) -> torch.Tensor:
    """Serial-parallel online multiplier (paper Fig. 2a).

    ``x_digits``: (n_in, *batch) SD stream, ``|x| < 1``.
    ``y``: parallel operand, broadcastable to ``batch``; ``|y| < 1``
    (the invariant needs ``|y| <= 1 - 2^-n``; int8 q-format weights satisfy
    it).  Emits ``n_out`` product digits MSDF with online delay ``delta``.

    For full precision of an n x m-bit product choose ``n_out >= n + m``
    (the paper uses p_mult = 16 for 8-bit operands).
    """
    y = torch.as_tensor(y, dtype=torch.float32, device=x_digits.device)
    u = x_digits.to(torch.float32) * y      # u_t = x_t * Y, |u_t| <= |Y| < 1
    return online_emit(u, n_out=n_out, delta=delta)


def _pad_digits(d: torch.Tensor, T: int) -> torch.Tensor:
    if d.shape[0] == T:
        return d
    pad = d.new_zeros((T - d.shape[0],) + tuple(d.shape[1:]))
    return torch.cat([d, pad], dim=0)


def online_add(a_digits: torch.Tensor, b_digits: torch.Tensor, n_out: int,
               delta: int = DELTA_ADD) -> torch.Tensor:
    """Digit-serial online adder emitting the scaled sum ``(a + b) / 2``.

    Both inputs are SD MSDF streams (padded with zero digits if lengths
    differ).  ``u_t = (a_t + b_t)/2 in [-1, 1]`` keeps the invariant; the
    output represents ``(A + B)/2`` exactly given enough output digits.
    """
    T = max(a_digits.shape[0], b_digits.shape[0])
    a = _pad_digits(a_digits, T).to(torch.float32)
    b = _pad_digits(b_digits, T).to(torch.float32)
    return online_emit((a + b) * 0.5, n_out=n_out, delta=delta)


def online_add_tree(streams: torch.Tensor, n_out: int,
                    delta: int = DELTA_ADD) -> tuple[torch.Tensor, int]:
    """Digit-pipelined reduction tree of online adders (paper Fig. 3).

    ``streams``: (n_terms, n_digits, *batch) SD streams.  Odd levels are
    padded with a zero stream and reduced pairwise; a depth-S tree emits
    the scaled SOP ``sum(streams) / 2^S``.

    Returns ``(digits, n_stages)``: the output stream (n_out, *batch) and
    the tree depth S = ceil(log2(n_terms)) used by the cycle model (eq. 6).
    """
    stages = 0
    level = streams                              # (terms, digits, *batch)
    while level.shape[0] > 1:
        if level.shape[0] % 2:
            level = torch.cat([level, level.new_zeros((1,) + tuple(
                level.shape[1:]))], dim=0)
        # one vectorized online_add per tree level, terms paired on axis 0
        a = level[0::2].movedim(0, 1)            # (digits, pairs, *batch)
        b = level[1::2].movedim(0, 1)
        summed = online_add(a, b, n_out=n_out, delta=delta)
        level = summed.movedim(1, 0)             # (pairs, n_out, *batch)
        stages += 1
    return level[0], stages
