"""host ms a step spends outside the step function (the benchmark's span loop_host)."""
from splatbench.metrics._read import host_ms


def read(t):
    return host_ms(t, "loop_host")
