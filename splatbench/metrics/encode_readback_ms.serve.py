"""host ms a frame in render_net_image, encode_u8 and the copy to the host (the benchmark's span encode_readback, after a synchronize)."""
from splatbench.metrics._read import host_ms


def read(t):
    return host_ms(t, "encode_readback")
