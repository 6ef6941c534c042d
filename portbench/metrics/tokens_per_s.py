"""Output tokens emitted in the window over the window's seconds."""
from portbench.harness.readers import window_tokens


def read(rec):
    n = window_tokens(rec)
    return n / rec["seconds"] if n else None
