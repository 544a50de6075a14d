"""Per-Gaussian preprocessing: homography, AABB, culling, SH colour.

Port of tpu_splat/raster/preprocess.py (itself the batched form of the
reference preprocessCUDA, forward.cu:148-253): one batched product builds
every splat->pixel homography, and culling is a validity mask.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from tpu_splat_torch.core import f32
from tpu_splat_torch.core.transforms import quat_to_rotmat
from tpu_splat_torch.core.sh import sh_to_color
from tpu_splat_torch.raster.config import (
    TILE,
    NEAR_N,
    CUTOFF,
    FILTER_SIZE,
    tile_grid,
)


class Preprocessed(NamedTuple):
    """Per-Gaussian rasterization attributes (all [P, ...])."""

    hom: torch.Tensor  # [P,3,3] homography rows (Tu, Tv, Tw)
    xy: torch.Tensor  # [P,2] screen-space AABB center (low-pass filter mean)
    depth: torch.Tensor  # [P] view-space z (sort key)
    normal_view: torch.Tensor  # [P,3] camera-facing view-space splat normal
    color: torch.Tensor  # [P,3] RGB from SH (or passthrough)
    radius: torch.Tensor  # [P] int32 screen radius (0 => culled)
    rect_min: torch.Tensor  # [P,2] int32 tile rect min (x,y)
    rect_max: torch.Tensor  # [P,2] int32 tile rect max (exclusive)
    tiles_touched: torch.Tensor  # [P] int32 rect area
    valid: torch.Tensor  # [P] bool


def ndc2pix_matrix(height: int, width: int, device="cpu") -> torch.Tensor:
    """[3,4] homogeneous NDC -> pixel map; px = ((x/w + 1) * W - 1) / 2."""
    return torch.tensor(
        [
            [width / 2.0, 0.0, 0.0, (width - 1) / 2.0],
            [0.0, height / 2.0, 0.0, (height - 1) / 2.0],
            [0.0, 0.0, 0.0, 1.0],
        ],
        dtype=torch.float32,
        device=device,
    )


def compute_homography(
    means3d: torch.Tensor,
    scales: torch.Tensor,
    rotations: torch.Tensor,
    full_proj: torch.Tensor,
    height: int,
    width: int,
    scale_modifier: float = 1.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Splat->pixel homographies [P,3,3] (rows Tu, Tv, Tw: hom @ (u,v,1) =
    (px*w, py*w, w)) and world normals [P,3] (forward.cu:75-115)."""
    R = quat_to_rotmat(rotations)  # [P,3,3]; columns are rotated axes
    s = scales * scale_modifier
    tan_u = R[..., :, 0] * s[..., 0:1]
    tan_v = R[..., :, 1] * s[..., 1:2]
    normal_world = R[..., :, 2]

    zeros = torch.zeros_like(s[..., 0])
    ones = torch.ones_like(zeros)
    s2w = torch.stack(
        [
            torch.cat([tan_u, zeros[..., None]], dim=-1),
            torch.cat([tan_v, zeros[..., None]], dim=-1),
            torch.cat([means3d, ones[..., None]], dim=-1),
        ],
        dim=-1,
    )  # [P,4,3]
    # Both products are written out elementwise in a fixed order, so the
    # homography has the same bits on every device and equals the JAX
    # package's CPU result: the tile rect's AABB extent cancels (center^2 -
    # conic term), and an ulp of difference here moves a rect edge by a tile.
    # [3,4] = ndc2pix @ full_proj: a sequential fused multiply-add chain
    # (a float64 sum of exact float32 products, rounded per step)
    N = ndc2pix_matrix(height, width, means3d.device)
    A = N[:, 0:1] * full_proj[0:1, :]
    for j in range(1, 4):
        A = (N[:, j : j + 1].double() * full_proj[j : j + 1, :].double() + A.double()).float()
    # [P,3,3] = A @ s2w, summed pairwise: (t0 + t1) + (t2 + t3)
    t = A[None, :, :, None] * s2w[:, None, :, :]  # [P,3,4,3]
    hom = (t[:, :, 0] + t[:, :, 1]) + (t[:, :, 2] + t[:, :, 3])
    return hom, normal_world


def compute_aabb(hom: torch.Tensor, cutoff: float = CUTOFF, cutoff_sq=None):
    """Screen AABB center + extent of the cutoff-sigma conic from the
    homography (forward.cu:119-145). Returns (center [P,2], extent [P,2],
    ok [P], h0 [P,2]); `cutoff_sq` [P] overrides the scalar cutoff.

    Rounded as the JAX package's jitted code: each sum over the three
    entries of (a*b)*c is the chain fma(a_k*b_k, c_k, acc), h0 is
    fma(center, center, -sum), the root is correctly rounded."""
    Tu, Tv, Tw = hom[..., 0, :], hom[..., 1, :], hom[..., 2, :]
    if cutoff_sq is None:
        t = torch.tensor(
            [cutoff * cutoff, cutoff * cutoff, -1.0], dtype=hom.dtype, device=hom.device
        ).expand(hom.shape[:-2] + (3,))
    else:
        t = torch.stack([cutoff_sq, cutoff_sq, -torch.ones_like(cutoff_sq)], dim=-1)
    d = f32.fma_sum(t * Tw, Tw)
    ok = d != 0.0
    f = t / torch.where(ok, d, torch.ones_like(d))[..., None]
    fu, fv = f * Tu, f * Tv
    sums = f32.fma_sum(torch.stack([fu, fv, fu, fv], -2), torch.stack([Tw, Tw, Tu, Tv], -2))
    center, s = sums[..., :2], sums[..., 2:]
    h0 = f32.fma(center, center, -s)
    extent = f32.sqrt(torch.clamp(h0, min=1e-4))
    return center, extent, ok, h0


def preprocess(
    means3d: torch.Tensor,
    scales: torch.Tensor,
    rotations: torch.Tensor,
    camera_world_view: torch.Tensor,
    camera_full_proj: torch.Tensor,
    camera_center: torch.Tensor,
    height: int,
    width: int,
    sh: torch.Tensor | None = None,
    sh_degree: int = 0,
    colors: torch.Tensor | None = None,
    scale_modifier: float = 1.0,
    screen_offset: torch.Tensor | None = None,
    hom_precomp: torch.Tensor | None = None,
    opacity: torch.Tensor | None = None,
    circular_rect: bool = False,
) -> Preprocessed:
    """Vectorized preprocess over all P Gaussians.

    `hom_precomp` [P,3,3] replaces the homography built from scales and
    rotations (the reference's transMat_precomp); the view normal is then
    +z, untransformed, as in the JAX package (reference forward.cu:207).

    `screen_offset` [P,2] is the densify probe: added to the homography's
    pixel-translation entries scaled by (W/2, H/2) and the depth T[2][2].
    `opacity` [P] (post-activation) enables the opacity-aware tile rect,
    which only drops (gaussian, tile) overlaps whose alpha stays below 1/255
    (see the JAX `preprocess` docstring); `radius` stays the 3-sigma value.
    """
    tiles_y, tiles_x = tile_grid(height, width)

    # the view transform and the sums below as the JAX package's jitted CPU
    # code rounds them (fma chains), with the same bits on every device
    if hom_precomp is not None:
        hom = hom_precomp
        p_view = f32.fma_sum(means3d[..., None, :], camera_world_view[:3, :3])
        p_view = p_view + camera_world_view[:3, 3]
        normal_view = torch.zeros_like(means3d)
        normal_view[..., 2] = 1.0
    else:
        hom, normal_world = compute_homography(
            means3d, scales, rotations, camera_full_proj, height, width, scale_modifier
        )
        views = f32.fma_sum(torch.stack([means3d, normal_world], -2)[..., None, :],
                            camera_world_view[:3, :3])  # [P, 2, 3]
        p_view = views[:, 0] + camera_world_view[:3, 3]
        normal_view = views[:, 1]
    in_front = p_view[..., 2] > NEAR_N  # auxiliary.h:189-214 near culling

    # DUAL_VISIABLE: flip normal toward camera (forward.cu:211-216)
    cosv = -f32.fma_sum(p_view, normal_view)
    normal_view = torch.sign(cosv)[..., None] * normal_view
    front_ok = cosv != 0.0

    center, extent, aabb_ok, _ = compute_aabb(hom)
    radius_f = torch.ceil(
        torch.clamp(torch.maximum(extent[..., 0], extent[..., 1]), min=CUTOFF * FILTER_SIZE)
    )
    radius = radius_f.to(torch.int32)

    if circular_rect:
        # reference-exact circular getRect (auxiliary.h:71-81)
        rx = ry = radius_f
    else:
        # per-axis ellipse AABB, floored at the low-pass footprint
        rx = torch.ceil(torch.clamp(extent[..., 0], min=CUTOFF * FILTER_SIZE))
        ry = torch.ceil(torch.clamp(extent[..., 1], min=CUTOFF * FILTER_SIZE))
    rxy = torch.stack([rx, ry], dim=-1)
    lo = center - rxy
    hi = center + rxy
    if opacity is not None:
        # alpha = o*exp(-rho/2) >= 1/255 requires rho <= rho_cut =
        # 2*ln(255*o): box the rho_cut level conic (its own AABB, about its
        # own center) union the low-pass disk, +1 px for f32 rounding at the
        # accept knife edge, capped at the 3-sigma box. Degenerate cut
        # conics keep the 3-sigma box.
        # (only the integer rect reads what follows: no gradient)
        with torch.no_grad():
            rho_cut = torch.clamp(
                2.0 * f32.log(torch.clamp(255.0 * opacity, min=1e-12)),
                0.0,
                CUTOFF * CUTOFF,
            )
            opa_ok = 255.0 * opacity >= 1.0
            center_c, extent_c, _, h0_c = compute_aabb(hom, cutoff_sq=rho_cut)
            cut_good = (
                (f32.fma_sum(hom[..., 2, :] * hom[..., 2, :], torch.stack(
                    [rho_cut, rho_cut, -torch.ones_like(rho_cut)], dim=-1
                )) < 0.0)
                & (h0_c[..., 0] > 1e-4)
                & (h0_c[..., 1] > 1e-4)
            )[..., None]
            lp = f32.sqrt(rho_cut)[..., None] * FILTER_SIZE
            half = torch.ceil(
                torch.maximum(torch.abs(center_c - center) + extent_c, lp) + 1.0
            )
            lo = torch.where(cut_good, torch.maximum(lo, center - half), lo)
            hi = torch.where(cut_good, torch.minimum(hi, center + half), hi)
    else:
        opa_ok = True
    rect_min = torch.stack(
        [
            torch.clamp(torch.floor(lo[..., 0] / TILE), 0, tiles_x),
            torch.clamp(torch.floor(lo[..., 1] / TILE), 0, tiles_y),
        ],
        dim=-1,
    ).to(torch.int32)
    rect_max = torch.stack(
        [
            torch.clamp(torch.floor((hi[..., 0] + TILE - 1) / TILE), 0, tiles_x),
            torch.clamp(torch.floor((hi[..., 1] + TILE - 1) / TILE), 0, tiles_y),
        ],
        dim=-1,
    ).to(torch.int32)
    area = (rect_max[..., 0] - rect_min[..., 0]) * (rect_max[..., 1] - rect_min[..., 1])

    valid = in_front & front_ok & aabb_ok & (area > 0) & opa_ok
    radius = torch.where(valid, radius, torch.zeros_like(radius))
    area = torch.where(valid, area, torch.zeros_like(area))

    if screen_offset is not None:
        # densify probe, scaled by the (stop-gradient) depth T[2][2] as the
        # reference's dL_dmean2D (backward.cu:656-659); added after the
        # AABB so it does not reach the low-pass center
        t22 = hom[..., 2, 2].detach()
        probe = torch.zeros_like(hom)
        probe[..., 0, 2] = 0.5 * width * t22 * screen_offset[..., 0]
        probe[..., 1, 2] = 0.5 * height * t22 * screen_offset[..., 1]
        hom = hom + probe

    if colors is None:
        dirs = means3d - camera_center
        n2 = torch.sum(dirs * dirs, dim=-1, keepdim=True)
        dirs = dirs / torch.sqrt(torch.clamp(n2, min=1e-16))
        color = sh_to_color(sh_degree, sh, dirs)
    else:
        color = colors

    return Preprocessed(
        hom=hom,
        xy=center,
        depth=p_view[..., 2],
        normal_view=normal_view,
        color=color,
        radius=radius,
        rect_min=rect_min,
        rect_max=rect_max,
        tiles_touched=area,
        valid=valid,
    )
