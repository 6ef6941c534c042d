"""The dense model's FLOPs of the admission steps over their summed wall
time and the bf16 peak (989 TFLOP/s), in percent."""
from portbench.harness.readers import admit_steps, mfu_pct


def read(rec):
    steps = admit_steps(rec)
    return mfu_pct(sum(s["flops"] for s in steps),
                   sum(s["t1"] - s["t0"] for s in steps))
