"""host syncs a frame (torch.cuda sync debug warnings)."""
from splatbench.metrics._read import syncs


def read(t):
    return syncs(t)
