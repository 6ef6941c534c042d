"""Device resolution and float32 precision for the port's entry points."""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch

__all__ = ["full_f32", "resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``; a CUDA device with no GPU present raises.

    There is no silent fallback to the CPU: CPU execution (the kernels' plain
    versions) happens only when the caller asks for ``device="cpu"``.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default, but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch versions on the CPU")
    return dev


@contextlib.contextmanager
def full_f32() -> Iterator[None]:
    """Full float32 products and convolutions (no TF32) inside the block.

    The reference computes in full f32.  cuBLAS matmuls default to f32 in
    PyTorch, but cuDNN convolutions default to TF32; both flags are pinned
    here and restored on exit.
    """
    matmul, cudnn = (torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn
