"""95th percentile of the gaps between consecutive tokens of a request,
over every gap that ends in the window.  A traced run's reading: the
gaps that span an admission step set it."""
from portbench.harness.readers import itl_ms, p95


def read(rec):
    return p95(itl_ms(rec))
