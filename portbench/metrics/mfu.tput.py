"""The dense model's FLOPs of the traced window over its length and the
bf16 peak (989 TFLOP/s), in percent."""
from portbench.harness.readers import mfu_pct, total_flops, trace_window_s


def read(rec):
    return mfu_pct(total_flops(rec), trace_window_s(rec))
