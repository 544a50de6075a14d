"""Volumetric (classic 3DGS) preprocessing, the second rasterizer family
(port of tpu_splat/raster/volumetric.py; the reference's
diff-gaussian-rasterization, SURVEY §2.5).

EWA splatting: the 3D covariance R diag(s^2) R^T projected through the
local perspective Jacobian to a 2D screen covariance (+0.3 px dilation,
optional Mip-Splatting antialiasing opacity rescale; forward.cu:113-224 of
the vendored diff-gaussian-rasterization).

No second blend kernel: each EWA Gaussian is encoded as an affine
homography for the surfel tile kernels,
  hom = z * [[A, mu], [0, 0, 1]],  A A^T = cov2D (2x2 SPD square root),
so the kernels' ray-splat solve gives s = A^-1 (pix - mu), rho3d = |s|^2 =
d^T cov2D^-1 d (the EWA falloff), and the blended depth is the view z. The
low-pass branch is switched off by a 2D mean far outside any pixel (rho2d
>> rho3d). Per-Gaussian `normals` are passed in and blended as given. The
`screen_offset` densify probe is 3DGS's `means2D`: added to the projected
centre, so its gradient is the loss's gradient there (in NDC units).

Rounded as the JAX package's jitted CPU code with the camera passed as an
argument, as its render() is (core/f32.py), with the same bits on every
device: each sum of products is an fma chain but two columns of one dot
(`_j_times_wv`), the square roots are correctly rounded, a Python number
divided by a tensor is a float32 divide (not PyTorch's reciprocal
multiply). The rect edges come from floor((center +- radius)/16), where an
ulp moves a tile. (With the camera folded into the jitted code as a
constant, XLA rounds the projection dots another way.)
"""
from __future__ import annotations

import torch

from tpu_splat_torch.core import f32
from tpu_splat_torch.core.sh import sh_to_color
from tpu_splat_torch.core.transforms import quat_to_rotmat
from tpu_splat_torch.raster.config import NEAR_N, TILE, tile_grid
from tpu_splat_torch.raster.preprocess import Preprocessed

DILATION = 0.3  # pixel dilation (forward.cu computeCov2D)


def _const(x: float, like: torch.Tensor) -> torch.Tensor:
    """A Python number as a 0-d tensor of `like`'s dtype and device, so
    that x / t is a true divide."""
    return torch.tensor(x, dtype=like.dtype, device=like.device)


def _det(c: torch.Tensor) -> torch.Tensor:
    """c00*c11 - c01*c10 of [P,2,2], contracted as XLA does."""
    return f32.fma(c[:, 0, 0], c[:, 1, 1], -(c[:, 0, 1] * c[:, 1, 0]))


def _j_times_wv(J: torch.Tensor, Wv: torch.Tensor) -> torch.Tensor:
    """einsum("pij,jk->pik", J, Wv) as XLA's CPU dot rounds it (read off
    its results): output columns 0 and 1 as float32 products added in
    order, (p0 + p1) + p2, unfused; column 2 the fma chain."""
    p = J[:, :, None, :] * Wv.T[:2]  # [P,2,2,3] float32 products
    seq = (p[..., 0] + p[..., 1]) + p[..., 2]
    fused = f32.fma_sum(J, Wv[:, 2])
    return torch.cat([seq, fused[..., None]], dim=-1)


def compute_cov2d(
    means3d: torch.Tensor,  # [P,3]
    scales3: torch.Tensor,  # [P,3]
    rotations: torch.Tensor,  # [P,4]
    world_view: torch.Tensor,  # [4,4]
    focal_x: float,
    focal_y: float,
    tan_fovx: float,
    tan_fovy: float,
    scale_modifier: float = 1.0,
):
    """EWA projection of the 3D covariance -> (cov2d [P,2,2] dilated,
    det [P], det_ratio [P] for antialiasing, p_view [P,3])."""
    R = quat_to_rotmat(rotations)
    s = scales3 * scale_modifier
    M = R * s[:, None, :]  # R @ diag(s)
    cov3d = f32.fma_sum(M[:, :, None, :], M[:, None, :, :])  # [P,3,3]

    Wv = world_view[:3, :3]
    p_view = f32.fma_sum(means3d[:, None, :], Wv) + world_view[:3, 3]
    tz = p_view[:, 2]
    # frustum-clamped tangent coords (forward.cu:162-170)
    lim_x, lim_y = 1.3 * tan_fovx, 1.3 * tan_fovy
    txtz = torch.clamp(p_view[:, 0] / tz, -lim_x, lim_x)
    tytz = torch.clamp(p_view[:, 1] / tz, -lim_y, lim_y)
    tx = txtz * tz
    ty = tytz * tz

    zero = torch.zeros_like(tz)
    tz2 = tz * tz
    J = torch.stack(
        [
            torch.stack([_const(focal_x, tz) / tz, zero, (-focal_x * tx) / tz2], dim=-1),
            torch.stack([zero, _const(focal_y, tz) / tz, (-focal_y * ty) / tz2], dim=-1),
        ],
        dim=-2,
    )  # [P,2,3]
    T = _j_times_wv(J, Wv)  # [P,2,3]
    # T cov3d T^T, contracted left to right (the einsum's path)
    X = f32.fma_sum(T[:, :, None, :], cov3d.transpose(1, 2)[:, None, :, :])  # [P,2,3]
    cov = f32.fma_sum(X[:, :, None, :], T[:, None, :, :])  # [P,2,2]

    det_raw = _det(cov)
    dil = torch.tensor([[DILATION, 0.0], [0.0, DILATION]], dtype=cov.dtype, device=cov.device)
    cov = cov + dil
    det = _det(cov)
    det_ratio = f32.sqrt(torch.clamp(det_raw / torch.clamp(det, min=1e-12), min=0.000025))
    return cov, det, det_ratio, p_view


def _sqrtm_2x2_spd(cov: torch.Tensor, det: torch.Tensor) -> torch.Tensor:
    """Principal square root of SPD 2x2: A = (cov + sqrt(det) I) / sqrt(tr + 2 sqrt(det))."""
    s = f32.sqrt(torch.clamp(det, min=1e-12))
    tr = cov[:, 0, 0] + cov[:, 1, 1]
    denom = f32.sqrt(torch.clamp(tr + 2.0 * s, min=1e-12))[:, None, None]
    eye = torch.eye(2, dtype=cov.dtype, device=cov.device)[None]
    return (cov + s[:, None, None] * eye) / denom


def preprocess_volumetric(
    means3d: torch.Tensor,
    scales3: torch.Tensor,  # [P,3] three axes
    rotations: torch.Tensor,
    normals: torch.Tensor,  # [P,3] per-Gaussian input normals (world)
    camera_world_view: torch.Tensor,
    camera_full_proj: torch.Tensor,
    camera_center: torch.Tensor,
    height: int,
    width: int,
    tan_fovx: float,
    tan_fovy: float,
    sh: torch.Tensor | None = None,
    sh_degree: int = 0,
    colors: torch.Tensor | None = None,
    scale_modifier: float = 1.0,
    antialiasing: bool = False,
    screen_offset: torch.Tensor | None = None,
) -> tuple[Preprocessed, torch.Tensor]:
    """-> (Preprocessed with affine homographies, opacity_scale [P]).

    opacity_scale is 1, or the Mip-Splatting h_convolution_scaling when
    `antialiasing` (multiply it into opacity before blending).
    `screen_offset` [P,2] (NDC) moves the blended centre by (W/2, H/2) times
    it, after the tile rect is taken, as the surfel preprocess adds its
    probe; absent, nothing changes."""
    tiles_y, tiles_x = tile_grid(height, width)
    focal_x = width / (2.0 * tan_fovx)
    focal_y = height / (2.0 * tan_fovy)

    cov, det, det_ratio, p_view = compute_cov2d(
        means3d, scales3, rotations, camera_world_view,
        focal_x, focal_y, tan_fovx, tan_fovy, scale_modifier,
    )
    in_front = p_view[:, 2] > NEAR_N
    det_ok = det > 0

    # projected center in pixels (ndc2Pix convention)
    hom_p = f32.fma_sum(means3d[:, None, :], camera_full_proj[:2, :3]) + camera_full_proj[:2, 3]
    w_p = f32.fma_sum(means3d, camera_full_proj[3, :3]) + camera_full_proj[3, 3]
    ndc = hom_p / (w_p[:, None] + 1e-7)
    wh = torch.tensor([width, height], dtype=ndc.dtype, device=ndc.device)
    center = f32.fma(ndc + 1.0, wh, -1.0) * 0.5

    # screen radius from the eigenvalues (forward.cu:227-231)
    mid = 0.5 * (cov[:, 0, 0] + cov[:, 1, 1])
    lam = mid + f32.sqrt(torch.clamp(f32.fma(mid, mid, -det), min=0.1))
    radius_f = torch.ceil(3.0 * f32.sqrt(lam))
    radius = radius_f.to(torch.int32)

    A = _sqrtm_2x2_spd(cov, det)
    z = p_view[:, 2:3]
    hom = torch.stack(
        [
            torch.cat([A[:, 0, :], center[:, 0:1]], dim=-1),
            torch.cat([A[:, 1, :], center[:, 1:2]], dim=-1),
            torch.cat([torch.zeros_like(center), torch.ones_like(z)], dim=-1),
        ],
        dim=-2,
    ) * z[:, :, None]  # [P,3,3]

    rect_min = torch.stack(
        [
            torch.clamp(torch.floor((center[:, 0] - radius_f) / TILE), 0, tiles_x),
            torch.clamp(torch.floor((center[:, 1] - radius_f) / TILE), 0, tiles_y),
        ],
        dim=-1,
    ).to(torch.int32)
    rect_max = torch.stack(
        [
            torch.clamp(torch.floor((center[:, 0] + radius_f + TILE - 1) / TILE), 0, tiles_x),
            torch.clamp(torch.floor((center[:, 1] + radius_f + TILE - 1) / TILE), 0, tiles_y),
        ],
        dim=-1,
    ).to(torch.int32)
    area = (rect_max[:, 0] - rect_min[:, 0]) * (rect_max[:, 1] - rect_min[:, 1])

    if screen_offset is not None:
        # scaled by the (stop-gradient) depth hom[2][2] = z, as the surfel
        # probe (raster/preprocess.py)
        t22 = hom[..., 2, 2].detach()
        probe = torch.zeros_like(hom)
        probe[..., 0, 2] = 0.5 * width * t22 * screen_offset[..., 0]
        probe[..., 1, 2] = 0.5 * height * t22 * screen_offset[..., 1]
        hom = hom + probe

    valid = in_front & det_ok & (area > 0)
    radius = torch.where(valid, radius, torch.zeros_like(radius))
    area = torch.where(valid, area, torch.zeros_like(area))

    if colors is None:
        dirs = means3d - camera_center
        n2 = torch.sum(dirs * dirs, dim=-1, keepdim=True)
        dirs = dirs / torch.sqrt(torch.clamp(n2, min=1e-16))
        color = sh_to_color(sh_degree, sh, dirs)
    else:
        color = colors

    # the low-pass branch off: a 2D mean far outside any pixel
    far_xy = torch.full_like(center, 1e7)
    normal_view = f32.fma_sum(normals[:, None, :], camera_world_view[:3, :3])
    opacity_scale = det_ratio if antialiasing else torch.ones_like(det)
    prep = Preprocessed(
        hom=hom,
        xy=far_xy,
        depth=p_view[:, 2],
        normal_view=normal_view,
        color=color,
        radius=radius,
        rect_min=rect_min,
        rect_max=rect_max,
        tiles_touched=area,
        valid=valid,
    )
    return prep, opacity_scale
