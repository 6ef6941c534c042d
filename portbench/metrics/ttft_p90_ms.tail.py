"""90th percentile of the time to first token, over every request whose
first token lands in the window, from when it was due or sent.  A traced
run's reading: near 70 first tokens a window put a run's p90 on the
residual steps of a handful of requests (PERF.md, section 2)."""
from portbench.harness.readers import percentile, ttft_ms


def read(rec):
    return percentile(ttft_ms(rec), 90.0)
