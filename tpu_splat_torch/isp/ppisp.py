"""Learned per-frame ISP post-processing (port of tpu_splat/isp/ppisp.py,
the PPISP role): a per-frame 3x3 colour matrix + bias and tone exponent, a
shared controller transform, and a per-camera radial vignette field.
Unknown frames (frame_idx = -1) or `use_controller` select the controller.
Regularization pulls the per-frame transforms toward identity and distills
the controller toward the per-frame mean.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from tpu_splat_torch.core.device import resolve_device


class ISPConfig(NamedTuple):
    use_controller: bool = True
    controller_distillation: bool = True
    controller_activation_ratio: float = 0.875
    reg_weight: float = 1e-3
    distill_weight: float = 1e-2


class ISPParams(NamedTuple):
    gain: torch.Tensor  # [F, 3, 3] per-frame colour matrix (identity init)
    bias: torch.Tensor  # [F, 3]
    log_gamma: torch.Tensor  # [F, 3] tone exponent (0 => gamma 1)
    ctrl_gain: torch.Tensor  # [3, 3] controller
    ctrl_bias: torch.Tensor  # [3]
    ctrl_log_gamma: torch.Tensor  # [3]
    vig_coef: torch.Tensor  # [C, 2] per-camera radial vignette (a1, a2)
    vig_center: torch.Tensor  # [C, 2] optical-centre offset, fraction of (W, H)


def init_isp(num_frames: int, num_cameras: int = 1, device="cuda") -> ISPParams:
    dev = resolve_device(device)
    eye = torch.eye(3, device=dev)
    z = lambda *s: torch.zeros(s, device=dev)
    return ISPParams(
        gain=eye[None].repeat(num_frames, 1, 1),
        bias=z(num_frames, 3),
        log_gamma=z(num_frames, 3),
        ctrl_gain=eye.clone(),
        ctrl_bias=z(3),
        ctrl_log_gamma=z(3),
        vig_coef=z(num_cameras, 2),
        vig_center=z(num_cameras, 2),
    )


def pixel_coord_grid(height: int, width: int, device="cpu") -> torch.Tensor:
    """[H, W, 2] (x, y) pixel-centre coordinates."""
    x = torch.arange(width, dtype=torch.float32, device=device) + 0.5
    y = torch.arange(height, dtype=torch.float32, device=device) + 0.5
    return torch.stack(torch.meshgrid(x, y, indexing="xy"), dim=-1)


def _vignette_gain(params: ISPParams, pixel_coords, resolution, camera_idx: int):
    """[H, W, 1] radial gain field 1 + a1 r^2 + a2 r^4 for one camera."""
    ci = max(int(camera_idx), 0)
    w, h = resolution
    wh = pixel_coords.new_empty(2, dtype=torch.float32)
    wh[0], wh[1] = w, h  # fills: no host-to-device copy, which would sync
    center = (0.5 + params.vig_center[ci]) * wh
    half_diag = 0.5 * torch.sqrt(torch.sum(wh**2))
    r2 = torch.sum(((pixel_coords - center) / half_diag) ** 2, dim=-1)
    a1, a2 = params.vig_coef[ci, 0], params.vig_coef[ci, 1]
    return (1.0 + a1 * r2 + a2 * r2 * r2)[..., None]


def _transform(rgb, gain, bias, log_gamma):
    out = torch.einsum("hwc,dc->hwd", rgb, gain) + bias
    gamma = torch.exp(log_gamma)
    # a maximum, as `jnp.clip` (1/2 gradient at a tie); at an exactly-zero
    # pixel the exponent's gradient is 0, as JAX's pow gives it
    base = torch.maximum(out, torch.zeros_like(out))
    # x ** gamma has an infinite slope at x = 0 when gamma < 1: the JAX
    # package's gradient there is inf, and one exactly-zero value (a clamped
    # pixel, or out == 0 exactly) turns the whole step's gradient NaN. There
    # the value is 0 and its gradient is taken as 0; everywhere else this is
    # max(out, 0) ** gamma, value and gradient, as in the JAX package
    steep = (base == 0) & (gamma < 1)
    safe = torch.where(steep, torch.ones_like(base), base)
    return torch.where(steep, torch.zeros_like(base), safe**gamma)


def apply_isp(
    params: ISPParams,
    rgb: torch.Tensor,  # [H, W, 3]
    frame_idx: int,
    use_controller: bool = False,
    pixel_coords: torch.Tensor | None = None,  # [H, W, 2]
    resolution: tuple | None = None,  # (W, H)
    camera_idx: int = 0,
) -> torch.Tensor:
    """frame_idx = -1 (unknown/test view) or `use_controller` selects the
    shared controller transform; otherwise the frame's own. The vignette
    field multiplies the input before the colour transform."""
    fi = int(frame_idx)
    if fi < 0 or use_controller:
        gain, bias, lg = params.ctrl_gain, params.ctrl_bias, params.ctrl_log_gamma
    else:
        gain, bias, lg = params.gain[fi], params.bias[fi], params.log_gamma[fi]
    h, w = rgb.shape[0], rgb.shape[1]
    if pixel_coords is None:
        pixel_coords = pixel_coord_grid(h, w, device=rgb.device)
    if resolution is None:
        resolution = (w, h)
    rgb = rgb * _vignette_gain(params, pixel_coords, resolution, camera_idx)
    return _transform(rgb, gain, bias, lg)


def isp_regularization(params: ISPParams, cfg: ISPConfig) -> torch.Tensor:
    """Identity pull + controller distillation toward the per-frame mean."""
    eye = torch.eye(3, device=params.gain.device)
    reg = (
        torch.mean((params.gain - eye) ** 2)
        + torch.mean(params.bias**2)
        + torch.mean(params.log_gamma**2)
        + torch.mean(params.vig_coef**2)
        + torch.mean(params.vig_center**2)
    )
    loss = cfg.reg_weight * reg
    if cfg.use_controller and cfg.controller_distillation:
        distill = (
            torch.mean((params.ctrl_gain - torch.mean(params.gain, dim=0)) ** 2)
            + torch.mean((params.ctrl_bias - torch.mean(params.bias, dim=0)) ** 2)
            + torch.mean((params.ctrl_log_gamma - torch.mean(params.log_gamma, dim=0)) ** 2)
        )
        loss = loss + cfg.distill_weight * distill
    return loss
