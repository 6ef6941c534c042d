"""Median wall time of the window's engine steps that ran an admission
forward (``pipeline.forwards`` advanced)."""
from portbench.harness.readers import admit_steps, median


def read(rec):
    walls = [(s["t1"] - s["t0"]) * 1e3 for s in admit_steps(rec)]
    return median(walls)
