"""Quaternion / activation / schedule math (port of
tpu_splat/core/transforms.py)."""
from __future__ import annotations

import math

import torch

from tpu_splat_torch.core import f32


def l2_norm(v: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """L2 norm along `dim` (kept as a size-1 dim) with the bits of the JAX
    package's `jnp.linalg.norm` on the CPU: the sum of squares is the fma
    chain of XLA's reduction, and the square root is correctly rounded
    (PyTorch's own float32 root on the CPU is not)."""
    v = v.movedim(dim, -1)
    return f32.sqrt(f32.fma_sum(v, v))[..., None].movedim(-1, dim)


def normalize(v: torch.Tensor, dim: int = -1, eps: float = 0.0) -> torch.Tensor:
    """L2-normalize along `dim`, with the bits of the JAX package's
    `v / jnp.linalg.norm(v)`. eps>0 guards the zero vector."""
    n = l2_norm(v, dim)
    return v / (n + eps) if eps else v / n


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """[..., 4] (w, x, y, z) unnormalized quaternion -> [..., 3, 3] rotation.
    Columns of R are the rotated basis axes; column 2 is the surfel normal.
    Each a*b +- c*d is fma(a, b, +-(c*d)), as the JAX package's jitted code
    contracts it (the first product is fused); 2*s and 1 - 2*s are exact
    or correctly rounded in float32."""
    q = normalize(q)
    w, x, y, z = q.unbind(-1)
    # r00 r01 r02 r10 r11 r12 r20 r21 r22, each 1 - 2 * f or 2 * f of
    # f = fma(a, b, c)
    f = f32.fma(torch.stack([y, x, x, x, x, y, x, y, x], -1),
                torch.stack([y, y, z, y, x, z, z, z, x], -1),
                torch.stack([z * z, -(w * z), w * y, w * z, z * z, -(w * x), -(w * y), w * x,
                             y * y], -1))
    diag = torch.tensor([1.0, 0, 0, 0, 1, 0, 0, 0, 1], device=q.device, dtype=q.dtype)
    return (diag - 2 * f).where(diag != 0, 2 * f).unflatten(-1, (3, 3))


def inverse_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return f32.log(x / (1.0 - x))


def expon_lr_schedule(
    lr_init: float,
    lr_final: float,
    lr_delay_steps: int = 0,
    lr_delay_mult: float = 1.0,
    max_steps: int = 1000000,
):
    """Log-linear lr decay with optional sine-warmup delay (reference
    utils/general_utils.py:29-62). The returned function maps a step to the
    rate, evaluated in float32 as the JAX package does."""
    as_f32 = lambda x: torch.tensor(x, dtype=torch.float32)

    def schedule(step) -> float:
        s = as_f32(float(step))
        if lr_init == 0.0 and lr_final == 0.0:
            return 0.0
        if lr_delay_steps > 0:
            delay_rate = lr_delay_mult + (1 - lr_delay_mult) * torch.sin(
                0.5 * math.pi * torch.clamp(s / lr_delay_steps, 0.0, 1.0)
            )
        else:
            delay_rate = 1.0
        t = torch.clamp(s / max_steps, 0.0, 1.0)
        log_lerp = torch.exp(torch.log(as_f32(lr_init)) * (1 - t) + torch.log(as_f32(lr_final)) * t)
        return 0.0 if float(s) < 0 else float(delay_rate * log_lerp)

    return schedule
