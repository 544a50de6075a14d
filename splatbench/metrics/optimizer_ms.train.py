"""ms a step in Adam and the densify statistics (spans adam, add_stats)."""
from splatbench.metrics._read import span_ms


def read(t):
    return span_ms(t, "adam", "add_stats")
