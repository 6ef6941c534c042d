"""The traced window over its engine steps, or over its ``generate``
decode steps, in milliseconds."""
from portbench.harness.readers import trace_window_s


def read(rec):
    if rec["kind"] == "batch":
        n = sum(b["decode_steps"] for b in rec["batches"])
    else:
        n = len(rec["steps"])
    return 1e3 * trace_window_s(rec) / n if n else None
