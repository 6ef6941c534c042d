"""Signed-digit (SD) radix-2 number system, the substrate of online
arithmetic (port of ``repro.core.digits``).

A value ``x`` with ``|x| < 1`` is represented most-significant-digit-first
(MSDF) as ``x = sum_i d_i * 2^-i`` (i = 1..n) with digits in {-1, 0, 1},
each stored in hardware as a bit pair ``(x+, x-)`` with ``d = x+ - x-``
(paper eq. 2).  A digit stream is an ``int8`` tensor whose LEADING axis is
the digit index, MSDF: ``digits.shape == (n, *batch)``.

Residuals and prefix values are multiples of ``2^-p`` for small ``p``, so
they are exact in float32 and every routine here is exact.
"""

from __future__ import annotations

import torch

from repro_torch.device import full_f32

__all__ = [
    "sd_from_value",
    "sd_to_value",
    "sd_prefix_values",
    "sd_split_posneg",
    "sd_from_bits_lsb",
    "fixed_to_sd",
    "first_negative_prefix",
]


def _select(v: torch.Tensor) -> torch.Tensor:
    """Radix-2 SD digit selection on the exact residual (thresholds
    +-1/2)."""
    return ((v >= 0.5).to(torch.int8) - (v <= -0.5).to(torch.int8))


def sd_from_value(x: torch.Tensor, n_digits: int) -> torch.Tensor:
    """Convert ``x`` (float, ``|x| < 1``) into ``n_digits`` SD radix-2
    digits, MSDF.

    Greedy exact-residual selection: ``w <- x``; per digit ``v = 2w``;
    ``d = sign(v)`` if ``|v| >= 1/2`` else ``0``; ``w <- v - d``.  The
    representation error after ``n`` digits is at most ``2^-n`` and is zero
    whenever ``x`` is a multiple of ``2^-n_digits``.

    Returns int8 digits of shape ``(n_digits, *x.shape)``.
    """
    w = torch.as_tensor(x).to(torch.float32)
    digits = []
    for _ in range(n_digits):
        v = 2.0 * w
        d = _select(v)
        w = v - d.to(torch.float32)
        digits.append(d)
    return torch.stack(digits)


def _digit_weights(n: int, device) -> torch.Tensor:
    return torch.exp2(-torch.arange(1, n + 1, dtype=torch.float32,
                                    device=device))


def sd_to_value(digits: torch.Tensor) -> torch.Tensor:
    """Value of an SD digit stream: ``sum_i d_i 2^-i`` (leading axis = i).

    A contraction over the digit axis, in full f32 on the card (no TF32).
    """
    weights = _digit_weights(digits.shape[0], digits.device)
    with full_f32():
        return torch.tensordot(weights, digits.to(torch.float32),
                               dims=([0], [0]))


def sd_prefix_values(digits: torch.Tensor) -> torch.Tensor:
    """Prefix values ``z[j] = sum_{i<=j} d_i 2^-i`` for every j (MSDF scan).

    Shape-preserving: output ``(n, *batch)`` float32.  This is what the
    paper's Algorithm-1 comparator observes (``z+[j] < z-[j]``  <=>
    ``z[j] < 0``).
    """
    n = digits.shape[0]
    weights = _digit_weights(n, digits.device).reshape(
        (n,) + (1,) * (digits.ndim - 1))
    return torch.cumsum(digits.to(torch.float32) * weights, dim=0)


def sd_split_posneg(digits: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Hardware bit-pair view (paper eq. 2): ``d = x+ - x-``; returns
    (x+, x-)."""
    return (digits > 0).to(torch.int8), (digits < 0).to(torch.int8)


def sd_from_bits_lsb(bits: torch.Tensor) -> torch.Tensor:
    """Reinterpret conventional bits (values {0,1}, leading axis = bit index
    MSB-first) as SD digits: any non-redundant representation is a valid SD
    one."""
    return torch.as_tensor(bits).to(torch.int8)


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


def first_negative_prefix(digits: torch.Tensor) -> torch.Tensor:
    """Index (1-based digit position) of the first strictly-negative prefix
    value, or ``n+1`` if no prefix ever goes negative (int32).  Paper
    Algorithm 1: the cycle at which the termination signal fires.

    A negative prefix at digit j means ``z[j] <= -2^-j`` while the remaining
    digits contribute ``< 2^-j``, so the final SOP is strictly negative and
    terminating is safe.
    """
    n = digits.shape[0]
    neg = sd_prefix_values(digits) < 0.0
    # torch.argmax refuses bool; on uint8 it returns the first maximum, the
    # first True (or 0 if none), as jnp.argmax does on bool
    idx = torch.argmax(neg.to(torch.uint8), dim=0).to(torch.int32)
    return torch.where(neg.any(dim=0), idx + 1,
                       torch.full_like(idx, n + 1))
