"""PyTorch/CUDA port of the DSLOT-NN digit-serial inference engine.

The package mirrors the JAX reference package ``repro`` module by module
(``kernels/``, ``layers/``, ``core/``, ...).  Plain tensor code is PyTorch;
the digit-serial matmul that the reference wrote as a Pallas TPU kernel is a
CUDA C++ kernel for Hopper (``kernels/csrc/dslot_matmul.cu``).

Backend rule: a CUDA tensor always launches the kernel; a CPU tensor runs the
kernel's plain PyTorch version (the grid replay).  Entry points that create
tensors run on ``cuda`` unless the caller passes ``device="cpu"``
(``repro_torch.device.resolve_device``).
"""

from .device import full_f32, resolve_device

__all__ = ["full_f32", "resolve_device"]
