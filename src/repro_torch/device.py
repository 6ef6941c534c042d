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
    """Products and convolutions accumulate in full float32 inside the
    block: no TF32, and no half-precision reduction of bf16/f16 products.

    The reference computes in full f32 and accumulates its bf16 products in
    f32.  cuBLAS matmuls default to f32 in PyTorch, but cuDNN convolutions
    default to TF32, and cuBLAS may reduce the split-K partial sums of a
    bf16 or f16 product in that type; every flag is pinned here and
    restored on exit.
    """
    mm, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = (mm.allow_tf32, cudnn.allow_tf32,
             mm.allow_bf16_reduced_precision_reduction,
             mm.allow_fp16_reduced_precision_reduction)
    mm.allow_tf32 = cudnn.allow_tf32 = False
    mm.allow_bf16_reduced_precision_reduction = False
    mm.allow_fp16_reduced_precision_reduction = False
    try:
        yield
    finally:
        (mm.allow_tf32, cudnn.allow_tf32,
         mm.allow_bf16_reduced_precision_reduction,
         mm.allow_fp16_reduced_precision_reduction) = saved
