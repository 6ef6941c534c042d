"""Model-facing DSLOT layers (port of ``repro.layers``): quantize -> digit
planes -> kernel -> dequantize, with per-layer early-termination
statistics."""

from .dslot import DslotConv2d, DslotDense, DslotLayerStats

__all__ = ["DslotConv2d", "DslotDense", "DslotLayerStats"]
