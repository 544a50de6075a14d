"""ms a step in the deferred reflection (span reflection)."""
from splatbench.metrics._read import span_ms


def read(t):
    return span_ms(t, "reflection")
