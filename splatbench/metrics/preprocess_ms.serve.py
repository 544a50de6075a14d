"""ms a frame in the preprocess (span preprocess)."""
from splatbench.metrics._read import span_ms


def read(t):
    return span_ms(t, "preprocess")
