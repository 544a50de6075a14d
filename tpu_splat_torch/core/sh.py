"""Real spherical harmonics, degree <= 3 (port of tpu_splat/core/sh.py).

Coefficients have layout [..., M, 3] with M = (deg+1)^2; the evaluated
colour is `0.5 + sum_m c_m Y_m(dir)`, clamped at 0 by `sh_to_color`.
"""
from __future__ import annotations

import torch

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
SH_C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)


def num_sh_coeffs(degree: int) -> int:
    return (degree + 1) ** 2


def sh_basis(degree: int, dirs: torch.Tensor) -> torch.Tensor:
    """Evaluate the SH basis at unit directions [..., 3] -> [..., M]."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    one = torch.ones_like(x)
    out = [SH_C0 * one]
    if degree > 0:
        out += [-SH_C1 * y, SH_C1 * z, -SH_C1 * x]
    if degree > 1:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        out += [
            SH_C2[0] * xy,
            SH_C2[1] * yz,
            SH_C2[2] * (2.0 * zz - xx - yy),
            SH_C2[3] * xz,
            SH_C2[4] * (xx - yy),
        ]
    if degree > 2:
        xx, yy, zz = x * x, y * y, z * z
        xy = x * y
        out += [
            SH_C3[0] * y * (3.0 * xx - yy),
            SH_C3[1] * xy * z,
            SH_C3[2] * y * (4.0 * zz - xx - yy),
            SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
            SH_C3[4] * x * (4.0 * zz - xx - yy),
            SH_C3[5] * z * (xx - yy),
            SH_C3[6] * x * (xx - 3.0 * yy),
        ]
    return torch.stack(out, dim=-1)


def eval_sh(degree: int, sh: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """sh: [..., M, C] coefficients, dirs: [..., 3] unit -> [..., C]. Only
    the first (degree+1)^2 coefficient rows are used."""
    m = num_sh_coeffs(degree)
    basis = sh_basis(degree, dirs)  # [..., m]
    return torch.einsum("...m,...mc->...c", basis, sh[..., :m, :])


def sh_to_color(degree: int, sh: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """SH -> RGB clamped at 0. A maximum, not a clamp: at exactly 0 its
    gradient splits 1/2 : 1/2 as `jnp.maximum`'s does."""
    raw = eval_sh(degree, sh, dirs) + 0.5
    return torch.maximum(raw, torch.zeros_like(raw))


def rgb_to_sh(rgb):
    """RGB in [0,1] -> DC SH coefficient (numpy or torch)."""
    return (rgb - 0.5) / SH_C0


def sh_to_rgb(sh):
    return sh * SH_C0 + 0.5
