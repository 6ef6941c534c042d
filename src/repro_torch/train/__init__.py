"""Training steps (port of ``repro.train``)."""
