"""ms a frame in binning (span binning)."""
from splatbench.metrics._read import span_ms


def read(t):
    return span_ms(t, "binning")
