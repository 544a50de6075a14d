"""The scheduled events around the training step (port of
tpu_splat/train/loop.py; role of the reference train.py:201-320 no_grad
block): the densification window, opacity resets, the opacity-LR pulse,
normal propagation, colour sabotage and env-map doubling, at the
reference's intervals and gates. The conditions are the same host-side
integer comparisons as the JAX package's; each event transforms the
TrainState on its device.

Random draws (the split children's normals, the sabotage noise) are taken
on the CPU from the state's torch.Generator and then moved, as
`init_cubemap` does, so a seed gives the same draws on every device; a
caller may hand in its own draws (`draws`), as the parity tests do with the
JAX package's.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from tpu_splat_torch.core import f32
from tpu_splat_torch.model import ops
from tpu_splat_torch.model.densify import densify_and_prune
from tpu_splat_torch.train.step import TrainState

COLOR_NOISE = 0.4  # dist_color's U(-0.4, 0.4) range (reference :278-284)

# name, shape -> a CPU float32 tensor of draws
Draws = Callable[[str, tuple], torch.Tensor]


def generator_draws(generator: torch.Generator) -> Draws:
    """The events' draws from a CPU generator: "densify_eps" standard
    normals [2, P, k] for the split children (k scale axes: 2 for surfels,
    3 for volumetric Gaussians), "color_noise" U(-0.4, 0.4) shaped like
    features_dc."""
    def draw(name: str, shape: tuple) -> torch.Tensor:
        if name == "densify_eps":
            return torch.randn(shape, generator=generator)
        if name == "color_noise":
            return torch.rand(shape, generator=generator) * (2 * COLOR_NOISE) - COLOR_NOISE
        raise ValueError(f"unknown draw {name!r}")

    return draw


@dataclasses.dataclass
class EventLog:
    """The JAX package's event log, whose `events` also record the
    opacity-LR pulse (normal propagation may zero the rate in the same
    iteration, so the rate alone does not show that the pulse fired)."""

    densified: int = 0
    pruned: int = 0
    overflowed: int = 0
    events: list = dataclasses.field(default_factory=list)


def outside_scope_mask(state, opt_cfg):
    """train.py:60-63 get_outside_msk: [P] rows outside the env scope
    sphere, or None without a scope."""
    if not opt_cfg.use_env_scope:
        return None
    c = torch.as_tensor(opt_cfg.env_scope_center, dtype=torch.float32, device=state.device)
    return torch.sum((state.xyz - c[None]) ** 2, dim=-1) > opt_cfg.env_scope_radius**2


@torch.no_grad()
def run_scheduled_events(
    ts: TrainState,
    iteration: int,
    opt_cfg,
    cameras_extent: float,
    cameras_mean: np.ndarray,
    scene_frozen: bool = False,
    log: Optional[EventLog] = None,
    draws: Optional[Draws] = None,
) -> TrainState:
    """Apply every event scheduled at `iteration` (the branch conditions of
    train.py:227-290). Host reads: the densify counts, once per densify
    event, for the log."""
    log = log if log is not None else EventLog()
    draws = draws if draws is not None else generator_draws(ts.generator)
    densify_until = opt_cfg.densify_until_iter + opt_cfg.longer_prop_iter
    normal_prop_until = opt_cfg.normal_prop_until_iter + opt_cfg.longer_prop_iter
    sabotage_until = opt_cfg.color_sabotage_until_iter + opt_cfg.longer_prop_iter

    g, opt = ts.gaussians, ts.opt
    dev = g.device

    if iteration == densify_until:
        g, opt = ops.double_env_map(g, opt)
        log.events.append((iteration, "double_env_map"))

    opacity_reset_0 = False
    if (not scene_frozen) and iteration < densify_until:
        in_prop_window = opt_cfg.init_until_iter < iteration <= normal_prop_until
        interval = (
            opt_cfg.densification_interval_when_prop
            if (not opt_cfg.disable_normal_propagation and in_prop_window)
            else opt_cfg.densification_interval
        )
        if iteration > opt_cfg.densify_from_iter and iteration % interval == 0:
            res = densify_and_prune(
                g, opt, ts.stats, draws("densify_eps", (2, g.capacity, g.scaling.shape[1])).to(dev),
                grad_threshold=opt_cfg.densify_grad_threshold,
                percent_dense=opt_cfg.percent_dense,
                extent=cameras_extent,
                cameras_mean=torch.as_tensor(np.asarray(cameras_mean), dtype=torch.float32,
                                             device=dev),
                size_prune=iteration > opt_cfg.opacity_reset_interval,
            )
            g, opt = res.state, res.opt_state
            ts = dataclasses.replace(ts, stats=res.stats)
            log.densified += int(res.n_cloned) + int(res.n_split)
            log.pruned += int(res.n_pruned)
            log.overflowed += int(res.overflow)

        if iteration % opt_cfg.opacity_reset_interval == 0:
            opacity_reset_0 = True
            g, opt = ops.reset_opacity(g, opt)
            log.events.append((iteration, "reset_opacity"))

        if (opt_cfg.opac_lr0_interval > 0
                and (iteration - 500) % opt_cfg.opac_lr0_interval == 0 and in_prop_window):
            ts = dataclasses.replace(ts, opacity_lr=float(np.float32(opt_cfg.opacity_lr)))
            log.events.append((iteration, "opacity_lr_pulse"))

        if (iteration - 500) % opt_cfg.normal_prop_interval == 0 and in_prop_window:
            if not opacity_reset_0 and not opt_cfg.disable_normal_propagation:
                outside = outside_scope_mask(g, opt_cfg)
                opac_mask = f32.sigmoid(g.opacity[:, 0]) > 0.9
                if outside is not None:
                    opac_mask = opac_mask | outside
                g, opt = ops.reset_opacity(g, opt, reset_value=0.9, exclusive_msk=opac_mask)

                scale_mask = f32.sigmoid(g.refl[:, 0]) < 0.02
                if outside is not None:
                    scale_mask = scale_mask | outside
                g, opt = ops.reset_scale(g, opt, enlarge_scale=1.5, exclusive_msk=scale_mask)

                g, opt = ops.reset_refl(g, opt, opt_cfg.refl_init_value)

                if opt_cfg.opac_lr0_interval > 0 and iteration != normal_prop_until:
                    ts = dataclasses.replace(ts, opacity_lr=0.0)
                log.events.append((iteration, "normal_prop"))

    if (
        (iteration - 500) % opt_cfg.color_sabotage_interval == 0
        and opt_cfg.init_until_iter < iteration <= sabotage_until
        and not opt_cfg.disable_color_sabotage
    ):
        color_mask = f32.sigmoid(g.refl[:, 0]) > 0.1
        outside = outside_scope_mask(g, opt_cfg)
        if outside is not None:
            color_mask = color_mask | outside
        noise = draws("color_noise", tuple(g.features_dc.shape)).to(dev)
        g, opt = ops.dist_color(g, opt, noise, exclusive_msk=color_mask)
        log.events.append((iteration, "color_sabotage"))

    return dataclasses.replace(ts, gaussians=g, opt=opt)


def is_scene_frozen(iteration: int, opt_cfg, post_process: bool) -> bool:
    """The ISP controller freeze (train.py:71-75,123-124): for the last
    5000 iterations the Gaussians stop training and only the ISP refines."""
    if not post_process:
        return False
    ratio = (opt_cfg.iterations - 5000) / opt_cfg.iterations
    return iteration >= ratio * opt_cfg.iterations
