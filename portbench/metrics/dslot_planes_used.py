"""Mean DSLOT digit planes per tile over the requests finished in the
window (``GenerateResult.planes_used_mean``)."""
from portbench.harness.readers import planes_mean


def read(rec):
    return planes_mean(rec)
