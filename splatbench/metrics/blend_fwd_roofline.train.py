"""percent of the tile blend forward's roofline: its bound over span tile_blend_forward."""
from splatbench.metrics._read import roofline


def read(t):
    return roofline(t, "fwd_ops", "fwd_bytes", "tile_blend_forward")
