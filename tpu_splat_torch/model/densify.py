"""Adaptive density control at static capacity (port of
tpu_splat/model/densify.py; role of the reference densify/prune machinery,
scene/gaussian_model.py:484-584 + add_densification_stats).

Rows live in a fixed-capacity array with an `alive` mask: pruning clears
the mask, and clone/split children are placed into free rows by a
prefix-sum ranking (no allocation; candidates beyond the free rows are
reported as `overflow`, for capacity growth). In order, as densify_and_prune
:551-577: weight pruning (mean max blend weight < 0.01), clone (hot and
small) and split (hot and large: two children drawn on the Gaussian's
scale axes, two for a surfel and three for a volumetric Gaussian, scales
/ (0.8 N), the original dies), world-size pruning, then every statistic
reset and the Adam moments of new rows zeroed. The split draws come in as
`eps`, so both packages can be fed the same numbers.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from tpu_splat_torch.core import f32
from tpu_splat_torch.core.transforms import l2_norm, quat_to_rotmat
from tpu_splat_torch.model.optim import AdamState
from tpu_splat_torch.model.state import GaussianState

GAUSSIAN_PARAM_KEYS = ("xyz", "features_dc", "features_rest", "opacity", "scaling",
                       "rotation", "refl")


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


class DensifyResult(NamedTuple):
    state: GaussianState
    opt_state: AdamState
    stats: DensifyStats
    n_cloned: torch.Tensor
    n_split: torch.Tensor
    n_pruned: torch.Tensor
    overflow: torch.Tensor  # candidates dropped for lack of free rows


@torch.no_grad()
def densify_and_prune(
    state: GaussianState,
    opt_state: AdamState,
    stats: DensifyStats,
    eps: torch.Tensor,  # [N, P, k] standard normal draws for the split children, k axes
    grad_threshold: float,
    percent_dense: float,
    extent: float,
    cameras_mean: torch.Tensor,  # [3]
    size_prune: bool = True,
    weight_prune_threshold: float = 0.01,
    N: int = 2,
) -> DensifyResult:
    """One densify/prune event on the device the state lives on (no host
    read: the counts come back as tensors)."""
    P = state.capacity
    alive = state.alive
    scaling = f32.exp(state.scaling)  # [P, k]
    max_scale = scaling.max(-1).values
    zero = torch.zeros_like(max_scale)

    # 1. weight pruning (:552-555)
    mean_w = torch.where(stats.denom_w > 0, stats.accum_w / stats.denom_w, zero)
    survivors = alive & ~((mean_w < weight_prune_threshold) & alive)

    grads = torch.where(stats.denom > 0, stats.grad_accum / stats.denom, zero)
    hot = survivors & (torch.nan_to_num(grads, nan=0.0) >= grad_threshold)
    clone_sel = hot & (max_scale <= percent_dense * extent)
    split_sel = hot & (max_scale > percent_dense * extent)

    # 4. world-size pruning of the originals (clones copy their source, so
    # the rule applied to a clone source is the reference's rule applied
    # after densification)
    inside = torch.sum((state.xyz - cameras_mean[None]) ** 2, dim=-1) < extent**2
    big_ws = ((max_scale > 0.1 * extent) & inside) | ((max_scale > 1.5 * extent) & ~inside)
    big_ws = big_ws & bool(size_prune)
    clone_sel = clone_sel & ~big_ws
    keep = survivors & ~split_sel & ~big_ws

    # candidate rows: [clone children; split children A; split children B].
    # A split child is R[:, :, :k] @ (eps * scale) + xyz: the stds of the
    # k scale axes (a surfel's third axis is zero), rotated
    R = quat_to_rotmat(state.rotation)  # [P, 3, 3]
    e = eps.to(state.xyz.device) * scaling[None]  # [N, P, k]
    offs = R[None, :, :, 0] * e[..., 0:1] + R[None, :, :, 1] * e[..., 1:2]  # [N, P, 3]
    for j in range(2, e.shape[-1]):
        offs = offs + R[None, :, :, j] * e[..., j:j + 1]
    split_xyz = state.xyz[None] + offs
    split_scaling = f32.log(scaling / (0.8 * N))
    cand_mask = torch.cat([clone_sel, split_sel, split_sel])  # [3P]

    # free-row compaction: the k-th candidate goes to the k-th free row (in
    # row order); the rest go to the dump row P
    n_free = (~keep).sum()
    free_list = torch.sort(keep.to(torch.uint8), stable=True).indices  # free rows first
    rank = torch.cumsum(cand_mask.long(), 0) - 1
    ok = cand_mask & (rank < n_free)
    dst = torch.where(ok, free_list[torch.clamp(rank, 0, P - 1)], torch.full_like(rank, P))

    def place(arr, cand):
        padded = torch.cat([arr, torch.zeros_like(arr[:1])])
        padded[dst] = cand
        return padded[:P]

    new_params = {}
    for k in GAUSSIAN_PARAM_KEYS:
        arr = getattr(state, k)
        if k == "xyz":
            cand = torch.cat([arr, split_xyz[0], split_xyz[1]])
        elif k == "scaling":
            cand = torch.cat([arr, split_scaling, split_scaling])
        else:
            cand = torch.cat([arr, arr, arr])
        new_params[k] = place(arr, cand)
    placed = torch.zeros(P + 1, dtype=torch.bool, device=alive.device)
    placed[dst] = ok
    new_alive = keep | placed[:P]
    is_new = new_alive & ~keep

    # Adam moments: survivors keep their rows, new rows start from zero
    # (reference _prune_optimizer / cat_tensors_to_optimizer)
    mu, nu = dict(opt_state.mu), dict(opt_state.nu)
    for k in GAUSSIAN_PARAM_KEYS:
        m = is_new.reshape((-1,) + (1,) * (mu[k].dim() - 1))
        mu[k] = torch.where(m, torch.zeros_like(mu[k]), mu[k])
        nu[k] = torch.where(m, torch.zeros_like(nu[k]), nu[k])

    return DensifyResult(
        state=dataclasses.replace(state, **new_params, alive=new_alive),
        opt_state=opt_state._replace(mu=mu, nu=nu),
        stats=DensifyStats.zeros(P, device=alive.device),
        n_cloned=clone_sel.sum(),
        n_split=split_sel.sum(),
        n_pruned=alive.sum() - keep.sum(),
        overflow=cand_mask.sum() - ok.sum(),
    )
