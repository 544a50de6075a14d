"""ms a step in tight binning's run decode (spans tight_level1_decode, tight_column_range, tight_level2_decode)."""
from splatbench.metrics._read import span_ms


def read(t):
    return span_ms(t, "tight_level1_decode", "tight_column_range", "tight_level2_decode")
