"""ms a step in the backward outside its child spans: span backward less
tile_blend_backward, regroup_sort, segment_sum, cubemap_accumulate and
preprocess_vjp (autograd's own work and the backward of the plain layers)."""
from splatbench.metrics._read import span_ms

CHILDREN = ("tile_blend_backward", "regroup_sort", "segment_sum", "cubemap_accumulate",
            "preprocess_vjp")


def read(t):
    whole = span_ms(t, "backward")
    if whole is None:
        return None
    return whole - (span_ms(t, *CHILDREN) or 0.0)
