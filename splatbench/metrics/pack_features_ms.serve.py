"""ms a frame packing instance rows (span pack_features)."""
from splatbench.metrics._read import span_ms


def read(t):
    return span_ms(t, "pack_features")
