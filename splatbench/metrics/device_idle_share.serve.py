"""percent of the traced window with no device operation running (torch.profiler)."""
from splatbench.metrics._read import idle_share


def read(t):
    return idle_share(t)
