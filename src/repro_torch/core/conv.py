"""im2col lowering of convolutions onto the digit-serial matmul (port of
``repro.core.conv.im2col``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["im2col"]


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
