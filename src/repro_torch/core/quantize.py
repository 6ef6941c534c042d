"""Fixed-point quantization for the digit-serial datapath (port of
``repro.core.quantize``).

Symmetric quantization to ``n_bits`` with ``q`` an integer and the fraction
fed to the online operators ``frac = q / 2^(n-1)``, ``|frac| < 1``:

    q = clip(round(x / s * qmax), -qmax, qmax),   qmax = 2^(n-1) - 1

The order of operations (``x / s * qmax``, then a round half to even, as
``jnp.round``) is the reference's, so ``q`` is bit-equal to it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["QTensor", "quantize", "dequantize", "quantize_unsigned"]


class QTensor(NamedTuple):
    """Symmetric fixed-point tensor: ``value ~= frac * scale``.

    ``q``     int32 integers in [-(2^{n-1}-1), 2^{n-1}-1]
    ``scale`` float32 per-tensor scale applied to the *fraction* q / 2^{n-1}
    ``n_bits`` total fraction bits (n-1 magnitude bits)
    """
    q: torch.Tensor
    scale: torch.Tensor
    n_bits: int

    @property
    def frac(self) -> torch.Tensor:
        """Fractional value in (-1, 1) fed digit-serially to online
        operators."""
        return self.q.to(torch.float32) * (2.0 ** -(self.n_bits - 1))

    @property
    def value(self) -> torch.Tensor:
        return self.frac * self.scale


def _scale_eff(scale, n_bits: int, qmax: int, device) -> torch.Tensor:
    # value = (q / 2^{n-1}) * scale_eff  with  scale_eff = scale * 2^{n-1}/qmax
    return torch.as_tensor(scale, dtype=torch.float32, device=device) * (
        2.0 ** (n_bits - 1) / qmax)


def quantize(x: torch.Tensor, n_bits: int = 8,
             scale: torch.Tensor | float | None = None) -> QTensor:
    """Symmetric signed quantization to ``n_bits`` (default int8-like)."""
    x = torch.as_tensor(x).to(torch.float32)
    qmax = 2 ** (n_bits - 1) - 1
    if scale is None:
        scale = torch.clamp_min(x.abs().max(), 1e-12)
    q = torch.clamp(torch.round(x / scale * qmax), -qmax, qmax)
    return QTensor(q=q.to(torch.int32),
                   scale=_scale_eff(scale, n_bits, qmax, x.device),
                   n_bits=n_bits)


def quantize_unsigned(x: torch.Tensor, n_bits: int = 8,
                      scale: torch.Tensor | float | None = None) -> QTensor:
    """Unsigned quantization for post-ReLU activations (the image pixels are
    fed serially as non-negative fractions).  Digits stay in {0, 1}."""
    x = torch.as_tensor(x).to(torch.float32)
    qmax = 2 ** (n_bits - 1) - 1   # keep |frac| < 1 with the same n-1 split
    if scale is None:
        scale = torch.clamp_min(x.max(), 1e-12)
    q = torch.clamp(torch.round(x / scale * qmax), 0, qmax)
    return QTensor(q=q.to(torch.int32),
                   scale=_scale_eff(scale, n_bits, qmax, x.device),
                   n_bits=n_bits)


def dequantize(t: QTensor) -> torch.Tensor:
    return t.value
