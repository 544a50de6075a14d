"""host syncs a step (torch.cuda sync debug warnings)."""
from splatbench.metrics._read import syncs


def read(t):
    return syncs(t)
