"""CSD / Booth nonzero-digit enumeration (essential digits only; port of
``repro.core.csd``).

Bit-Pragmatic and Laconic process only the *essential* (nonzero) digits of
a serial operand instead of scanning every bit position.  This module
recodes quantized activations into **Canonical Signed Digit** form, the
unique minimal-weight radix-2 signed-digit representation (digits in
{-1, 0, +1}, no two adjacent nonzeros), through the non-adjacent-form
identity ``NAF(m) = bits(3m) - bits(m)``, and gives the integer-domain
evaluation and work accounting:

* ``csd_recode``: (P, ...) MSDF digit planes, ``P = n_bits + 1``,
  value-exact.
* ``essential_digit_count`` / ``binary_digit_count``: nonzero digits under
  CSD vs plain sign-magnitude binary.
* ``csd_matmul``: exact integer matmul over the CSD planes, plus the number
  of planes that carry any nonzero digit.

Counts are int32, as the reference's (``torch.sum`` widens to int64, so
they are cast back).
"""

from __future__ import annotations

import torch

__all__ = ["binary_digit_count", "csd_matmul", "csd_planes_nonzero",
           "csd_recode", "essential_digit_count"]


def csd_recode(q: torch.Tensor, n_bits: int = 8) -> torch.Tensor:
    """MSDF CSD digit planes of integer ``q``: (n_bits + 1, *q.shape) int8.

    Plane ``p`` carries weight ``2^(n_bits - p)`` (most significant first),
    so ``q == sum_p 2^(n_bits - p) * planes[p]`` exactly for
    ``|q| < 2^n_bits``.  Signed inputs recode as ``sign(q) * CSD(|q|)``.
    """
    q = torch.as_tensor(q).to(torch.int32)
    m = q.abs()
    t = 3 * m
    # NAF digit at weight 2^j is bit_{j+1}(3m) - bit_{j+1}(m); plane p has
    # j = n_bits - p, hence shift n_bits - p + 1
    shifts = n_bits + 1 - torch.arange(n_bits + 1, dtype=torch.int32,
                                       device=q.device)
    shifts = shifts.reshape(shifts.shape + (1,) * q.ndim)
    digits = ((t[None] >> shifts) & 1) - ((m[None] >> shifts) & 1)
    return (digits * torch.sign(q)[None]).to(torch.int8)


def essential_digit_count(planes: torch.Tensor) -> torch.Tensor:
    """Number of nonzero digits in a digit-plane tensor (i32 scalar)."""
    return (torch.as_tensor(planes) != 0).sum(dtype=torch.int32)


def binary_digit_count(q: torch.Tensor, n_bits: int = 8) -> torch.Tensor:
    """Nonzero digits of plain sign-magnitude binary (popcount of |q|): what
    the dense-plane scan multiplies by something nonzero, while it still
    issues ``n_bits * q.size`` digit slots (i32 scalar)."""
    m = torch.as_tensor(q).to(torch.int32).abs()
    shifts = torch.arange(n_bits, dtype=torch.int32, device=m.device)
    shifts = shifts.reshape(shifts.shape + (1,) * m.ndim)
    return ((m[None] >> shifts) & 1).sum(dtype=torch.int32)


def csd_planes_nonzero(planes: torch.Tensor) -> torch.Tensor:
    """How many of the P digit planes carry any nonzero digit (i32): an
    all-zero CSD plane needs no product at all."""
    flat = torch.as_tensor(planes).reshape(planes.shape[0], -1)
    return (flat != 0).any(dim=1).sum(dtype=torch.int32)


def csd_matmul(q: torch.Tensor, w_q: torch.Tensor, n_bits: int = 8
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact integer matmul over CSD planes: ``(q @ w_q, planes_nonzero)``.

    ``q``: (M, K) int, ``|q| < 2^n_bits``; ``w_q``: (K, N) int.  Evaluates
    ``sum_p 2^(n_bits-p) * (planes[p] @ w_q)`` in int32, bit-equal to
    ``q @ w_q`` (keep ``2^n_bits * K * max|w_q|`` inside int32 range).

    Each plane product runs in float64 on either device (CUDA has no
    integer matmul): its operands are integers and every partial sum is an
    integer of magnitude at most ``K * max|w_q| < 2^31``, far below 2^53,
    so the float64 product is exact, and it is converted back to int32
    before the int32 accumulation.
    """
    planes = csd_recode(q, n_bits)
    w_f = torch.as_tensor(w_q).to(device=planes.device,
                                  dtype=torch.int32).to(torch.float64)
    acc = planes.new_zeros((planes.shape[1], w_f.shape[1]),
                           dtype=torch.int32)
    for p in range(n_bits + 1):
        prod = (planes[p].to(torch.float64) @ w_f).to(torch.int32)
        acc = acc + (1 << (n_bits - p)) * prod
    return acc, csd_planes_nonzero(planes)
