"""Digit arithmetic, MSR analysis, im2col and the paper's MNIST CNN."""
