"""Mean time to first token, over every request whose first token lands
in the window, from when it was due or sent."""
from portbench.harness.readers import mean, ttft_ms


def read(rec):
    return mean(ttft_ms(rec))
