"""Quaternion / activation / schedule math (port of
tpu_splat/core/transforms.py)."""
from __future__ import annotations

import math

import torch


def l2_norm(v: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """L2 norm along `dim` (kept as a size-1 dim) with the bits of the JAX
    package's `jnp.linalg.norm` on the CPU: the sum of squares is acc =
    x0*x0, then acc = fma(xk, xk, acc) for each further k, and the square
    root is correctly rounded. Each fused step and the root are taken in
    float64 (the float32 product is exact there) and rounded once to
    float32; PyTorch's own float32 root on the CPU is not correctly rounded."""
    d = v.double()
    acc = (d.narrow(dim, 0, 1) ** 2).float()
    for k in range(1, v.shape[dim]):
        xk = d.narrow(dim, k, 1)
        acc = (xk * xk + acc.double()).float()
    return torch.sqrt(acc.double()).float()


def normalize(v: torch.Tensor, dim: int = -1, eps: float = 0.0) -> torch.Tensor:
    """L2-normalize along `dim`, with the bits of the JAX package's
    `v / jnp.linalg.norm(v)`. eps>0 guards the zero vector."""
    n = l2_norm(v, dim)
    return v / (n + eps) if eps else v / n


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """[..., 4] (w, x, y, z) unnormalized quaternion -> [..., 3, 3] rotation.
    Columns of R are the rotated basis axes; column 2 is the surfel normal."""
    q = normalize(q)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - w * z)
    r02 = 2 * (x * z + w * y)
    r10 = 2 * (x * y + w * z)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - w * x)
    r20 = 2 * (x * z - w * y)
    r21 = 2 * (y * z + w * x)
    r22 = 1 - 2 * (x * x + y * y)
    return torch.stack(
        [
            torch.stack([r00, r01, r02], dim=-1),
            torch.stack([r10, r11, r12], dim=-1),
            torch.stack([r20, r21, r22], dim=-1),
        ],
        dim=-2,
    )


def inverse_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.log(x / (1.0 - x))


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
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)

    def schedule(step) -> float:
        s = f32(float(step))
        if lr_init == 0.0 and lr_final == 0.0:
            return 0.0
        if lr_delay_steps > 0:
            delay_rate = lr_delay_mult + (1 - lr_delay_mult) * torch.sin(
                0.5 * math.pi * torch.clamp(s / lr_delay_steps, 0.0, 1.0)
            )
        else:
            delay_rate = 1.0
        t = torch.clamp(s / max_steps, 0.0, 1.0)
        log_lerp = torch.exp(torch.log(f32(lr_init)) * (1 - t) + torch.log(f32(lr_final)) * t)
        return 0.0 if float(s) < 0 else float(delay_rate * log_lerp)

    return schedule
