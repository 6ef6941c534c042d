"""Signed-digit (SD) radix-2 recoding of fixed-point integers (port of
``repro.core.digits``; only what the kernel oracle needs).

A digit stream is an ``int8`` tensor whose LEADING axis is the digit index,
most significant digit first (MSDF): ``digits.shape == (n, *batch)``.
"""

from __future__ import annotations

import torch

__all__ = ["fixed_to_sd"]


def fixed_to_sd(q: torch.Tensor, n_bits: int) -> torch.Tensor:
    """Exact SD recoding of a signed fixed-point integer
    ``q in [-(2^n-1), 2^n-1]`` interpreted as the fraction ``q / 2^n``.
    Returns ``(n_bits, *q.shape)`` int8.

    Sign-magnitude binary: ``|q|``'s bits (MSB first) times ``sign(q)`` —
    digits in {-1, 0, 1}, exact.  ``q`` is widened to int32 first, so an
    unsigned storage type gives the same digits as its signed value.
    """
    q = torch.as_tensor(q).to(torch.int32)
    sign = torch.sign(q).to(torch.int8)
    mag = q.abs()
    shifts = torch.arange(n_bits - 1, -1, -1, dtype=torch.int32,
                          device=q.device)
    shifts = shifts.reshape((n_bits,) + (1,) * q.ndim)
    bits = ((mag[None] >> shifts) & 1).to(torch.int8)
    return bits * sign[None]
