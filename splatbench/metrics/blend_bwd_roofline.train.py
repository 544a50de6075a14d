"""percent of the tile blend backward's roofline: its bound over span tile_blend_backward."""
from splatbench.metrics._read import roofline


def read(t):
    return roofline(t, "bwd_ops", "bwd_bytes", "tile_blend_backward")
