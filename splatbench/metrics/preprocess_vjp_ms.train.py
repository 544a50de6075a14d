"""ms a step in the preprocess VJP (span preprocess_vjp)."""
from splatbench.metrics._read import span_ms


def read(t):
    return span_ms(t, "preprocess_vjp")
