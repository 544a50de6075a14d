"""Densification statistics (port of the stats half of
tpu_splat/model/densify.py: `DensifyStats` and `add_stats`). The
densify/prune event itself belongs to a later slice."""
from __future__ import annotations

from typing import NamedTuple

import torch

from tpu_splat_torch.core.transforms import l2_norm


class DensifyStats(NamedTuple):
    """Per-Gaussian accumulators (reference training_setup :190-193)."""

    grad_accum: torch.Tensor  # [P] sum of screen-space grad norms
    denom: torch.Tensor  # [P]
    accum_w: torch.Tensor  # [P] sum of max blend weights
    denom_w: torch.Tensor  # [P]
    max_radii: torch.Tensor  # [P] max screen radius seen

    @classmethod
    def zeros(cls, capacity: int, device="cpu") -> "DensifyStats":
        return cls(*(torch.zeros((capacity,), dtype=torch.float32, device=device)
                     for _ in range(5)))


@torch.no_grad()
def add_stats(
    stats: DensifyStats,
    screen_grad: torch.Tensor,  # [P, 2] gradient of the screen_offset probe
    visibility: torch.Tensor,  # [P] bool (radii > 0)
    gaussian_weights: torch.Tensor,  # [P] max blend weight this frame
    radii: torch.Tensor,  # [P]
) -> DensifyStats:
    """Reference add_densification_stats (:579-584) + max_radii2D tracking
    (train.py:242-243). The gradient norm is taken as the JAX package's
    `jnp.linalg.norm` rounds it."""
    gnorm = l2_norm(screen_grad, -1)[:, 0]
    vis = visibility.to(torch.float32)
    wmask = (gaussian_weights > 0.0).to(torch.float32)
    return DensifyStats(
        grad_accum=stats.grad_accum + gnorm * vis,
        denom=stats.denom + vis,
        accum_w=stats.accum_w + gaussian_weights * wmask,
        denom_w=stats.denom_w + wmask,
        max_radii=torch.maximum(stats.max_radii, radii.to(torch.float32) * vis),
    )
