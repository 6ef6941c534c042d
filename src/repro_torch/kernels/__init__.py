"""Digit-serial matmul: CUDA kernel, plain version and prepare/execute ops."""
