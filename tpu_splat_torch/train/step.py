"""The training step (port of tpu_splat/train/step.py: `TrainState`,
`StepAux`, `make_train_step`, `make_train_step_dp`; role of the reference
train.py:120-320 inner loop).

One step: render (rasterize, deferred reflection), optional alpha
compositing, the learned ISP, L1 + SSIM, normal consistency, ISP
regularization; gradients of the loss in the parameters and in the
`screen_offset` densify probe; the learning-rate schedule (xyz decay and
freeze, the pulsed opacity rate, scene freeze with the ISP still training);
Adam; the SH-degree bump; the densify statistics. The scheduled events
(densify, resets, sabotage, env doubling) run between steps and are not part
of it. The stage and the schedule are Python values here: PyTorch runs
eagerly, so nothing is traced or recompiled.

Over a mesh of ranks (dist/mesh.py), `make_train_step(mesh=...)` renders
one camera with its tile grid split over the ranks and
`make_train_step_dp` one camera per rank; either way every rank ends the
step with the same parameters, optimizer moments and statistics.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from tpu_splat_torch.core.device import stage
from tpu_splat_torch.core.graphics import Camera
from tpu_splat_torch.core.transforms import l2_norm
from tpu_splat_torch.dist.collectives import all_max_, all_mean, all_sum_, axis_size
from tpu_splat_torch.isp.ppisp import (
    ISPConfig,
    ISPParams,
    apply_isp,
    init_isp,
    isp_regularization,
)
from tpu_splat_torch.model.densify import DensifyStats, add_stats
from tpu_splat_torch.model.optim import AdamState, adam_init, adam_step, default_lrs, xyz_lr_schedule
from tpu_splat_torch.model.state import GaussianState
from tpu_splat_torch.raster.config import RasterConfig
from tpu_splat_torch.renderer.render import render
from tpu_splat_torch.train.losses import l1_loss, ssim

_ISP_LEAVES = ("gain", "bias", "log_gamma", "ctrl_gain", "ctrl_bias", "ctrl_log_gamma",
               "vig_coef", "vig_center")


def _isp_leaves(isp: ISPParams) -> dict:
    return {f"isp_{k}": getattr(isp, k) for k in _ISP_LEAVES}


def _isp_from_leaves(p: dict) -> ISPParams:
    return ISPParams(**{k: p[f"isp_{k}"] for k in _ISP_LEAVES})


def _f32(v: float) -> float:
    """A learning rate rounded to float32, as the JAX step holds it."""
    return float(np.float32(v))


@dataclasses.dataclass
class TrainState:
    gaussians: GaussianState
    opt: AdamState
    stats: DensifyStats
    step: int  # 1-based like the reference loop (0 before the first step)
    opacity_lr: float  # pulsed by the normal-propagation events
    generator: torch.Generator  # for the scheduled events' draws
    isp: ISPParams | None = None  # learned per-frame ISP (PPISP role)

    @classmethod
    def create(cls, gaussians: GaussianState, opt_cfg, seed: int = 0,
               num_frames: int | None = None) -> "TrainState":
        dev = gaussians.device
        isp = init_isp(num_frames, device=dev) if num_frames is not None else None
        params = gaussians.param_pytree()
        if isp is not None:
            params = {**params, **_isp_leaves(isp)}
        return cls(
            gaussians=gaussians,
            opt=adam_init(params),
            stats=DensifyStats.zeros(gaussians.capacity, device=dev),
            step=0,
            opacity_lr=_f32(opt_cfg.opacity_lr),
            generator=torch.Generator().manual_seed(seed),
            isp=isp,
        )


class StepAux(NamedTuple):
    loss: torch.Tensor
    l1: torch.Tensor
    ssim: torch.Tensor
    normal_loss: torch.Tensor
    psnr: torch.Tensor
    num_instances: torch.Tensor
    max_tile_count: torch.Tensor
    n_alive: torch.Tensor
    pad_overflow: torch.Tensor
    render: torch.Tensor  # [H, W, 3] the rendered image (before the ISP)
    surf_normal: torch.Tensor  # [H, W, 3]
    grads: dict  # parameter gradients of this step, and "screen_offset"


def make_train_step(
    opt_cfg,
    cfg: RasterConfig,
    spatial_lr_scale: float,
    use_env_scope: bool = False,
    env_scope_center=(0.0, 0.0, 0.0),
    env_scope_radius: float = 0.0,
    isp_cfg: ISPConfig | None = None,
    mesh=None,
    mesh_axis: str = "tiles",
):
    """Build the train step. `opt_cfg` is an OptimizationParams-like object
    (tpu_splat_torch/config.py). With `isp_cfg` (and TrainState.isp
    present), the render is post-processed by the learned per-frame ISP
    before the loss and the ISP regularization joins the objective; the ISP
    keeps training while the scene is frozen, and unknown frames
    (frame_idx = -1) use the shared controller. The step's
    `learning_rates(step, opacity_lr, frozen)` is the schedule it applies.

    With a `mesh`, every rank of it calls the step on the same inputs; the
    render splits the tile grid and the env pass over the ranks, and the
    rest of the step (loss, Adam, statistics) runs replicated on the whole
    frame, so each rank holds the whole gradient without a further sum.
    A `pix_mask` [H, W, 1] keeps the padded pixels of a bucketed camera out
    of every image-space loss term."""
    xyz_sched = xyz_lr_schedule(opt_cfg, spatial_lr_scale)
    base_lrs = default_lrs(opt_cfg, spatial_lr_scale)
    lambda_dssim = opt_cfg.lambda_dssim
    lambda_normal = opt_cfg.lambda_normal
    refl_mask_loss_weight = 0.4  # train.py:60 refl_mask_loss_weight
    freeze_xyz_from = opt_cfg.iterations - opt_cfg.freeze_xyz_last_iters

    def learning_rates(step: int, opacity_lr: float, frozen: bool) -> dict:
        """Float32 rates per parameter group (train.py:126-129, 232-233,
        260-281): the xyz decay, xyz and rotation frozen for the last
        freeze_xyz_last_iters steps, the pulsed opacity rate; a scene freeze
        zeroes every Gaussian rate while the ISP keeps training."""
        lrs = dict(base_lrs)
        lrs["xyz"] = xyz_sched(step)
        lrs["opacity"] = opacity_lr
        if step > freeze_xyz_from:
            lrs["xyz"] = lrs["rotation"] = 0.0
        lrs = {k: 0.0 if frozen else _f32(v) for k, v in lrs.items()}
        lrs["isp"] = _f32(base_lrs["isp"])
        return lrs

    def loss_fn(params, screen_offset, state: GaussianState, camera, gt_image, gt_alpha,
                bg, initial_stage, frame_idx, frozen, pix_mask=None):
        g = state.with_params(params)
        center = torch.as_tensor(env_scope_center, dtype=torch.float32, device=g.device)
        out = render(
            g, camera, cfg, bg, initial_stage=initial_stage,
            env_scope_center=center if use_env_scope else None,
            env_scope_radius=env_scope_radius if use_env_scope else 0.0,
            screen_offset=screen_offset, mesh=mesh, mesh_axis=mesh_axis,
        )
        with stage("loss"):
            rgb, gt = out.render, gt_image
            if gt_alpha is not None:
                # composite both over bg with their alphas (train.py:154-159)
                gt = gt * gt_alpha + (1 - gt_alpha) * bg
                rgb = rgb * out.alpha + (1 - out.alpha) * bg
            if isp_cfg is not None:
                rgb = apply_isp(_isp_from_leaves(params), rgb, frame_idx, use_controller=frozen)
            if pix_mask is None:
                l1 = l1_loss(rgb, gt)
                ssim_v = ssim(rgb, gt)
            else:
                # camera-size bucketing: padded pixels are out of every
                # image-space term; the SSIM window sees zeros across the pad
                # boundary (the reference pads its convolutions the same way)
                denom = torch.clamp(pix_mask.sum(), min=1.0)
                l1 = torch.sum(torch.abs(rgb - gt) * pix_mask) / (denom * rgb.shape[-1])
                smap = ssim(rgb, gt, return_map=True)
                ssim_v = torch.sum(smap * pix_mask) / (denom * smap.shape[-1])
            loss = (1.0 - lambda_dssim) * l1 + lambda_dssim * (1.0 - ssim_v)
            if use_env_scope:
                # suppress reflections outside the scope sphere (train.py:56-63,176-179)
                outside = torch.sum((g.xyz - center[None]) ** 2, dim=-1) > env_scope_radius**2
                live = outside & g.alive
                refl_msk_loss = torch.sum(g.get_refl() * live) / torch.clamp(live.sum(), min=1)
                loss = loss + refl_mask_loss_weight * refl_msk_loss
            # normal consistency (train.py:182-189)
            normal_err = 1.0 - torch.sum(out.normal * out.surf_normal, dim=-1, keepdim=True)
            if use_env_scope:
                normal_err = normal_err * out.scope_mask
            if pix_mask is None:
                normal_loss = lambda_normal * torch.mean(normal_err)
            else:
                normal_loss = lambda_normal * (torch.sum(normal_err * pix_mask)
                                               / torch.clamp(pix_mask.sum(), min=1.0))
            if not opt_cfg.disable_normal_consistentcy_loss:
                loss = loss + normal_loss
            if isp_cfg is not None:
                loss = loss + isp_regularization(_isp_from_leaves(params), isp_cfg)
            if pix_mask is None:
                mse = torch.mean((rgb - gt) ** 2)
            else:
                mse = torch.sum((rgb - gt) ** 2 * pix_mask) / torch.clamp(
                    pix_mask.sum() * rgb.shape[-1], min=1.0)
        return loss, (out, l1, ssim_v, normal_loss, mse)

    def value_and_grads(ts: TrainState, camera, gt_image, bg, gt_alpha, frozen, frame_idx,
                        pix_mask):
        """-> (the parameter values, their gradients and the screen_offset
        probe's, (loss, render output, l1, ssim, normal_loss, mse))."""
        initial_stage = ts.step + 1 < opt_cfg.init_until_iter
        values = ts.gaussians.param_pytree()
        if isp_cfg is not None:
            values = {**values, **_isp_leaves(ts.isp)}
        params = {k: v.detach().requires_grad_(True) for k, v in values.items()}
        so = torch.zeros((ts.gaussians.capacity, 2), device=ts.gaussians.device,
                         requires_grad=True)
        with torch.enable_grad():
            loss, (out, l1, ssim_v, normal_loss, mse) = loss_fn(
                params, so, ts.gaussians, camera, gt_image, gt_alpha, bg,
                initial_stage, frame_idx, frozen, pix_mask,
            )
            with stage("backward"):
                leaves = list(params.values()) + [so]
                got = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = {k: torch.zeros_like(x) if gr is None else gr
                 for k, x, gr in zip(list(params) + ["screen_offset"], leaves, got)}
        values = {k: v.detach() for k, v in params.items()}
        return values, grads, (loss.detach(), out, l1.detach(), ssim_v.detach(),
                               normal_loss.detach(), mse.detach())

    def apply_update(ts: TrainState, values: dict, grads: dict, frozen: bool,
                     stats: DensifyStats) -> TrainState:
        """Adam under the schedule and the SH-degree bump; -> the next state."""
        step = ts.step + 1
        lrs = learning_rates(step, ts.opacity_lr, frozen)
        with stage("adam"):
            new_params, new_opt = adam_step(values, grads, ts.opt, lrs)
        new_g = ts.gaussians.with_params(new_params)
        new_isp = _isp_from_leaves(new_params) if isp_cfg is not None else ts.isp
        # SH degree ramp every 1000 its after feature_rest_from_iter
        # (train.py:131-132)
        if step > opt_cfg.feature_rest_from_iter and step % 1000 == 0 and not frozen:
            new_g = dataclasses.replace(
                new_g, active_sh_degree=min(new_g.active_sh_degree + 1, new_g.max_sh_degree)
            )
        return dataclasses.replace(ts, gaussians=new_g, opt=new_opt, stats=stats, step=step,
                                   isp=new_isp)

    def train_step(
        ts: TrainState,
        camera: Camera,
        gt_image: torch.Tensor,
        bg: torch.Tensor,
        gt_alpha: torch.Tensor | None = None,
        frozen: bool = False,
        frame_idx: int = -1,
        pix_mask: torch.Tensor | None = None,
    ) -> tuple[TrainState, StepAux]:
        values, grads, (loss, out, l1, ssim_v, normal_loss, mse) = value_and_grads(
            ts, camera, gt_image, bg, gt_alpha, frozen, frame_idx, pix_mask)
        with stage("add_stats"):
            stats = add_stats(ts.stats, grads["screen_offset"], out.visibility,
                              out.gaussian_weights, out.radii)
        new_ts = apply_update(ts, values, grads, frozen, stats)
        aux = StepAux(
            loss=loss, l1=l1, ssim=ssim_v, normal_loss=normal_loss,
            psnr=-10.0 * torch.log10(mse),
            num_instances=out.num_instances, max_tile_count=out.max_tile_count,
            n_alive=new_ts.gaussians.alive.sum(), pad_overflow=out.pad_overflow,
            render=out.render.detach(), surf_normal=out.surf_normal.detach(),
            grads=grads,
        )
        return new_ts, aux

    train_step.learning_rates = learning_rates
    train_step.value_and_grads = value_and_grads
    train_step.apply_update = apply_update
    return train_step


def make_train_step_dp(
    opt_cfg,
    cfg: RasterConfig,
    spatial_lr_scale: float,
    mesh,
    dp_axis: str = "dp",
    **step_kwargs,
):
    """Camera-batch data-parallel step: B cameras a step, one per rank of
    `mesh` along `dp_axis` (B == its size). Each rank renders its camera's
    whole frame with the single-camera loss; the ranks average every
    gradient leaf and the five loss scalars (one flat all-reduce), combine
    the densify statistics as B sequential `add_stats` calls would (sums of
    gnorm*vis, vis, w*wmask and wmask, the max of radii*vis), take the max
    of the diagnostics, and every rank takes the same Adam step on the
    mean gradient under the single-camera step's schedule.

    `dp_step(ts, cameras, gt_images, bg, gt_alphas=None, frozen=False,
    frame_idx=None, pix_masks=None)` takes the whole batch, as the JAX
    step does (sequences of B, or tensors with a leading B axis), and
    renders entry `mesh.rank`; every rank calls it with the same batch.
    StepAux.render, surf_normal and grads["screen_offset"] are the rank's
    own camera's."""
    axis_size(mesh, dp_axis)
    # each rank renders its whole frame: tile sharding is not composed here
    base = make_train_step(opt_cfg, cfg, spatial_lr_scale, **step_kwargs)

    def dp_step(ts: TrainState, cameras, gt_images, bg, gt_alphas=None, frozen: bool = False,
                frame_idx=None, pix_masks=None) -> tuple[TrainState, StepAux]:
        r = mesh.rank
        own = lambda x: None if x is None else x[r]
        fidx = -1 if frame_idx is None else int(frame_idx[r])
        values, grads, (loss, out, l1, ssim_v, normal_loss, mse) = base.value_and_grads(
            ts, cameras[r], gt_images[r], bg, own(gt_alphas), frozen, fidx, own(pix_masks))
        gso = grads.pop("screen_offset")
        keys = list(grads)
        with stage("grad_allreduce"):
            *means, scalars = all_mean(
                mesh, [grads[k] for k in keys] + [torch.stack([loss, l1, ssim_v, normal_loss,
                                                                mse])])
        grads = dict(zip(keys, means))
        loss, l1, ssim_v, normal_loss, mse = scalars
        with stage("add_stats"):
            vis = out.visibility.to(torch.float32)
            w = out.gaussian_weights
            wmask = (w > 0.0).to(torch.float32)
            sums = torch.stack([l2_norm(gso, -1)[:, 0] * vis, vis, w * wmask, wmask])
            radii = out.radii.to(torch.float32) * vis
            diag = torch.stack([out.num_instances, out.max_tile_count,
                                out.pad_overflow]).to(torch.int64)
            all_sum_(mesh, sums)
            all_max_(mesh, radii, diag)
            stats = DensifyStats(
                grad_accum=ts.stats.grad_accum + sums[0],
                denom=ts.stats.denom + sums[1],
                accum_w=ts.stats.accum_w + sums[2],
                denom_w=ts.stats.denom_w + sums[3],
                max_radii=torch.maximum(ts.stats.max_radii, radii),
            )
        new_ts = base.apply_update(ts, values, grads, frozen, stats)
        aux = StepAux(
            loss=loss, l1=l1, ssim=ssim_v, normal_loss=normal_loss,
            psnr=-10.0 * torch.log10(mse),
            num_instances=diag[0], max_tile_count=diag[1],
            n_alive=new_ts.gaussians.alive.sum(), pad_overflow=diag[2],
            render=out.render.detach(), surf_normal=out.surf_normal.detach(),
            grads={**grads, "screen_offset": gso},
        )
        return new_ts, aux

    dp_step.learning_rates = base.learning_rates
    return dp_step
