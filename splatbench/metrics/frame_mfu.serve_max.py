"""percent of the card's float32 peak the whole frame sustains: the window's counted operations over its seconds."""
from splatbench.metrics._read import mfu


def read(t):
    return mfu(t, "frame_ops")
