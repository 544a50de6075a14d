"""ms a step computing the volumetric Gaussians' shortest-axis normals (span normal_axis)."""
from splatbench.metrics._read import span_ms


def read(t):
    return span_ms(t, "normal_axis")
