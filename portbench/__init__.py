"""The port's benchmark: one harness driven by ``BENCHMARK.json`` and the
files beside it (configurations, traffic mixes, drivers, metric readers)."""
