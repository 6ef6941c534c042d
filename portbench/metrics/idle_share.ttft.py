"""Share of the traced window in which no operation ran on the card (the
union of the trace's device intervals), in percent."""
from portbench.harness.readers import idle_pct


def read(rec):
    return idle_pct(rec)
