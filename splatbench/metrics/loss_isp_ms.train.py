"""ms a step in the loss with the ISP, SSIM and the normal loss (span loss)."""
from splatbench.metrics._read import span_ms


def read(t):
    return span_ms(t, "loss")
