"""ms a step regrouping instance gradients per surfel (spans regroup_sort, segment_sum)."""
from splatbench.metrics._read import span_ms


def read(t):
    return span_ms(t, "regroup_sort", "segment_sum")
