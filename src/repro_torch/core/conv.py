"""DSLOT-NN convolution (port of ``repro.core.conv``): the im2col lowering
of convolutions onto the digit-serial matmul, and the fused conv + ReLU +
maxpool dataflow of the paper's datapath (Figs. 4-7) simulated digit by
digit.

Numerical contract (bit-exact): x is quantized unsigned to ``x_q`` (digit
stream of n digits valued ``x_q / 2^n``), w signed to ``w_q`` (fraction
``w_q / 2^n``).  A PE with S tree stages emits ``SOP_int / 2^(2n+S)`` where
``SOP_int = sum x_q*w_q``, integer-exact, so the digit-serial path equals
the SIP path exactly and the float conv up to quantization.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .digits import fixed_to_sd, sd_to_value
from .early_term import TerminationReport, early_termination
from .pe import PESchedule, pe_schedule, pe_sop_digits
from .quantize import quantize, quantize_unsigned
from .sip import sip_sop

__all__ = ["DSLOTConvResult", "extract_windows", "im2col",
           "dslot_conv2d_stats", "sip_conv2d"]

# Windows simulated at once by dslot_conv2d_stats: its digit streams and
# residuals take one to two KB per window and output map, so a chunk stays
# near 100 MB at 8 maps.  Windows are independent: chunks change no result.
WINDOW_CHUNK = 8192


class DSLOTConvResult(NamedTuple):
    y_conv: torch.Tensor          # (B, Ho, Wo, M) dequantized conv output (pre-ReLU)
    y_pooled: torch.Tensor        # (B, Ho//2, Wo//2, M) fused ReLU+maxpool output
    report: TerminationReport     # per-(B,Ho,Wo,M) Algorithm-1 accounting
    schedule: PESchedule
    x_scale: torch.Tensor
    w_scale: torch.Tensor


def im2col(x: torch.Tensor, k: int, stride: int = 1,
           padding: str = "valid") -> torch.Tensor:
    """Multi-channel im2col: (B, H, W, C) -> (B, Ho, Wo, k*k*C).

    ``padding``: "valid" (no pad) or "same" (zero-pad so that
    Ho = ceil(H / stride), with the extra pixel on the high side, as XLA's
    SAME).  Column order is (ki, kj, c): a matmul against weights reshaped
    from (k, k, C, M) to (k*k*C, M) is a conventional convolution.
    """
    if padding not in ("valid", "same"):
        raise ValueError(f"padding must be 'valid' or 'same', got {padding!r}")
    B, H, W, C = x.shape
    if padding == "same":
        Ho = -(-H // stride)
        Wo = -(-W // stride)
        ph = max((Ho - 1) * stride + k - H, 0)
        pw = max((Wo - 1) * stride + k - W, 0)
        x = F.pad(x, (0, 0, pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
        H, W = x.shape[1], x.shape[2]
    Ho = (H - k) // stride + 1
    Wo = (W - k) // stride + 1
    dev = x.device
    i = (stride * torch.arange(Ho, device=dev)[:, None, None, None]
         + torch.arange(k, device=dev)[None, None, :, None])     # (Ho,1,k,1)
    j = (stride * torch.arange(Wo, device=dev)[None, :, None, None]
         + torch.arange(k, device=dev)[None, None, None, :])     # (1,Wo,1,k)
    win = x[:, i, j]                                             # (B,Ho,Wo,k,k,C)
    return win.reshape(B, Ho, Wo, k * k * C)


def extract_windows(x: torch.Tensor, k: int) -> torch.Tensor:
    """im2col: (B, H, W) -> (B, Ho, Wo, k*k), valid padding, stride 1."""
    return im2col(x[..., None], k)


def _flat_windows(xq: torch.Tensor, k: int) -> tuple[torch.Tensor, tuple]:
    """Windows of the quantized image as (k*k, B*Ho*Wo) int32 columns."""
    win = extract_windows(xq, k)                        # (B, Ho, Wo, kk)
    B, Ho, Wo, KK = win.shape
    return win.reshape(B * Ho * Wo, KK).T, (B, Ho, Wo)


def dslot_conv2d_stats(x: torch.Tensor, w: torch.Tensor, *, n_bits: int = 8,
                       pool: int = 2) -> DSLOTConvResult:
    """Run the full DSLOT-NN digit-serial simulation of conv+ReLU+maxpool.

    ``x``: (B, H, W) float input feature map (a single input fmap).
    ``w``: (M, k, k) float kernels (M output feature maps), on x's device.

    Every output pixel's SOP is computed digit-serially through k*k online
    multipliers and the online adder tree, monitored by Algorithm 1.  The
    M maps are one broadcast (the reference maps over them one by one), and
    windows go through in chunks of ``WINDOW_CHUNK``.
    """
    M, k, k2 = w.shape
    if k != k2:
        raise ValueError(f"square kernels only, got {tuple(w.shape)}")
    schedule = pe_schedule(k=k, n_fmaps=1, p_mult=2 * n_bits)

    xq = quantize_unsigned(x, n_bits=n_bits)
    wq = quantize(w, n_bits=n_bits)
    flat, (B, Ho, Wo) = _flat_windows(xq.q, k)          # (kk, NW)

    # parallel weight fractions w_q/2^n, |.| < 1/2, as (kk, M, 1)
    w_frac = (wq.q.reshape(M, k * k).to(torch.float32)
              * (2.0 ** -n_bits)).T[:, :, None]
    sops = []
    for s in range(0, flat.shape[1], WINDOW_CHUNK):
        # digit streams valued q/2^n: (n_bits, kk, 1, windows)
        x_digits = fixed_to_sd(flat[:, s:s + WINDOW_CHUNK], n_bits)[:, :, None]
        sops.append(pe_sop_digits(x_digits, w_frac, schedule))  # (p_out, M, nw)
    sop_digits = torch.cat(sops, dim=2).permute(0, 2, 1)  # (p_out, NW, M)

    report = early_termination(sop_digits, schedule)

    # exact integer SOP from the digit stream: value * 2^(2n + S)
    S = schedule.tree_stages + schedule.fmap_stages
    sop_int = sd_to_value(sop_digits) * (2.0 ** (2 * n_bits + S))
    # x = (x_q/2^{n-1}) sx, w = (w_q/2^{n-1}) sw
    #  => SOP_real = SOP_int * sx*sw / 2^{2(n-1)}
    scale = xq.scale * wq.scale * (2.0 ** -(2 * (n_bits - 1)))
    y = (sop_int * scale).reshape(B, Ho, Wo, M)

    relu = torch.maximum(y, y.new_zeros(()))
    Hp, Wp = Ho // pool, Wo // pool
    pooled = relu[:, :Hp * pool, :Wp * pool, :].reshape(
        B, Hp, pool, Wp, pool, M).amax(dim=(2, 4))

    shape = (B, Ho, Wo, M)
    report = report._replace(
        is_negative=report.is_negative.reshape(shape),
        term_digit=report.term_digit.reshape(shape),
        cycles_used=report.cycles_used.reshape(shape),
        cycles_saved=report.cycles_saved.reshape(shape),
        savings_frac=report.savings_frac.reshape(shape),
    )
    return DSLOTConvResult(y_conv=y, y_pooled=pooled, report=report,
                           schedule=schedule, x_scale=xq.scale,
                           w_scale=wq.scale)


def sip_conv2d(x: torch.Tensor, w: torch.Tensor, *, n_bits: int = 8
               ) -> torch.Tensor:
    """The same convolution through the Stripes SIP baseline (bit-exact
    integer)."""
    M, k, _ = w.shape
    xq = quantize_unsigned(x, n_bits=n_bits)
    wq = quantize(w, n_bits=n_bits)
    flat, (B, Ho, Wo) = _flat_windows(xq.q, k)          # (kk, NW)
    sop = sip_sop(flat[:, None, :], wq.q.reshape(M, k * k).T[:, :, None],
                  n_bits=n_bits)                        # (M, NW)
    scale = xq.scale * wq.scale * (2.0 ** -(2 * (n_bits - 1)))
    return (sop.T.to(torch.float32) * scale).reshape(B, Ho, Wo, M)
