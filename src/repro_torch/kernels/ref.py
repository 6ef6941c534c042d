"""Plain PyTorch oracles for the digit-plane DSLOT kernel (port of
``repro.kernels.ref``).

The oracle defines the semantics the kernel must match (up to float
accumulation order): a quantized matmul evaluated MSDF over signed-digit
planes, with optional fused ReLU.  Early termination in the kernel is a pure
work saving, so the oracle computes the full product.
"""

from __future__ import annotations

import torch

from repro_torch.core.digits import fixed_to_sd
from repro_torch.device import full_f32

__all__ = ["make_planes", "sd_digit_plane", "dslot_matmul_ref",
           "plane_value_ref", "csd_matmul_ref"]


def make_planes(a_q: torch.Tensor, n_bits: int, n_planes: int | None = None
                ) -> torch.Tensor:
    """SD digit planes of an integer matrix, MSDF: int8 ``(D, M, K)`` with
    ``a_q ~= sum_d planes[d] * 2^(n_bits-1-d)`` (exact when D = n_bits)."""
    planes = fixed_to_sd(a_q, n_bits)
    if n_planes is not None:
        planes = planes[:n_planes]
    return planes


def sd_digit_plane(a_q: torch.Tensor, n_bits: int, d: int) -> torch.Tensor:
    """Plane ``d`` of ``make_planes(a_q, n_bits)`` without materializing the
    ``(D, ...)`` tensor: bit ``n_bits - 1 - d`` of ``|q|`` times ``sign(q)``.

    ``q`` is widened to int32 before ``abs``/``sign``: ``sign`` of an
    unsigned tensor would otherwise see no negative values and ``abs`` of the
    most negative narrow value would wrap.  Returns int8 digits in {-1,0,1}.
    """
    q = torch.as_tensor(a_q).to(torch.int32)
    bit = (q.abs() >> (n_bits - 1 - d)) & 1
    return (bit * torch.sign(q)).to(torch.int8)


def plane_value_ref(planes: torch.Tensor, n_bits: int) -> torch.Tensor:
    """Reconstruct the (possibly truncated) integer value of digit planes."""
    D = planes.shape[0]
    w = 2.0 ** (n_bits - 1 - torch.arange(D, dtype=torch.float32,
                                          device=planes.device))
    return torch.tensordot(w, planes.to(torch.float32), dims=([0], [0]))


def _plane_sum(planes: torch.Tensor, w: torch.Tensor, top: int) -> torch.Tensor:
    """``sum_d 2^(top - d) * planes[d] @ w`` in plane order, f32."""
    w = w.to(torch.float32)
    acc = torch.zeros((planes.shape[1], w.shape[1]), dtype=torch.float32,
                      device=w.device)
    with full_f32():
        for d in range(planes.shape[0]):
            acc = acc + 2.0 ** (top - d) * (planes[d].to(torch.float32) @ w)
    return acc


def dslot_matmul_ref(planes: torch.Tensor, w: torch.Tensor, n_bits: int,
                     relu: bool = True) -> torch.Tensor:
    """Oracle: ``C = [relu](A_D @ W)`` with ``A_D`` the plane-truncated
    integer activation, evaluated plane by plane MSDF in f32.

    planes: (D, M, K) int8;  w: (K, N).  Returns (M, N) float32.
    """
    acc = _plane_sum(planes, w, n_bits - 1)
    return torch.clamp_min(acc, 0.0) if relu else acc


def csd_matmul_ref(planes: torch.Tensor, w: torch.Tensor, n_bits: int,
                   relu: bool = False) -> torch.Tensor:
    """Oracle over CSD digit planes: plane ``p`` carries weight
    ``2^(n_bits - p)`` and there are ``n_bits + 1`` planes."""
    acc = _plane_sum(planes, w, n_bits)
    return torch.clamp_min(acc, 0.0) if relu else acc
