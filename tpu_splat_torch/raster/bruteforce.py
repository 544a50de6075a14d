"""Brute-force per-pixel rasterizer: a test oracle for toy scenes only
(port of tpu_splat/raster/bruteforce.py).

An independent re-implementation of the compositing semantics: every
pixel walks ALL Gaussians in global depth order (gated on the Gaussian's
tile rect covering the pixel's tile, which reproduces binning), with the
skip and termination rules of the reference renderCUDA (forward.cu:
357-460). Vectorised over the pixels, one step per Gaussian: O(H*W*P)
work and P sequential steps, so use it at a few hundred Gaussians and
tens of pixels a side, never in production.
"""
from __future__ import annotations

import torch

from tpu_splat_torch.raster.config import (
    ALPHA_MAX,
    ALPHA_MIN,
    FAR_N,
    FILTER_INV_SQUARE,
    NEAR_N,
    T_EPS,
    TILE,
)
from tpu_splat_torch.raster.preprocess import Preprocessed


def blend_bruteforce(
    prep: Preprocessed,
    opacity: torch.Tensor,
    refl: torch.Tensor,
    scope_mask: torch.Tensor,
    bg: torch.Tensor,
    height: int,
    width: int,
):
    """-> (color [H,W,3], others [H,W,8], refl [H,W], final_T [H,W],
    n_contrib [H,W] int32): the outputs of `rasterize` for the same
    preprocess, channel offsets as raster/__init__.py."""
    dev, dt = opacity.device, opacity.dtype
    order = torch.sort(prep.depth, stable=True).indices.tolist()
    py, px = torch.meshgrid(torch.arange(height, device=dev), torch.arange(width, device=dev),
                            indexing="ij")
    tile_x, tile_y = px // TILE, py // TILE
    pxf, pyf = px.to(dt), py.to(dt)

    z = lambda: torch.zeros((height, width), dtype=dt, device=dev)
    T = torch.ones((height, width), dtype=dt, device=dev)
    done = torch.zeros((height, width), dtype=torch.bool, device=dev)
    C = torch.zeros((height, width, 3), dtype=dt, device=dev)
    N = torch.zeros((height, width, 3), dtype=dt, device=dev)
    D, R, dist, m1, m2, med_d = z(), z(), z(), z(), z(), z()
    scope = torch.zeros_like(done)
    rank = torch.zeros((height, width), dtype=torch.int32, device=dev)
    med_i, ncon = torch.zeros_like(rank), torch.zeros_like(rank)
    zero = torch.zeros((), dtype=dt, device=dev)
    for g in order:
        rmin, rmax = prep.rect_min[g], prep.rect_max[g]
        covered = (prep.valid[g] & (rmin[0] <= tile_x) & (tile_x < rmax[0])
                   & (rmin[1] <= tile_y) & (tile_y < rmax[1]))
        rank = rank + covered.to(torch.int32)
        Tu, Tv, Tw = prep.hom[g, 0], prep.hom[g, 1], prep.hom[g, 2]
        k = pxf[..., None] * Tw - Tu
        l = pyf[..., None] * Tw - Tv
        p = torch.linalg.cross(k, l, dim=-1)
        unstable = torch.abs(p[..., 2]) < 1e-4
        p2 = torch.where(unstable, torch.ones_like(p[..., 2]), p[..., 2])
        s = torch.where(unstable[..., None], zero, p[..., :2] / p2[..., None])
        rho3d = torch.where(unstable, torch.full_like(p2, 1e8), torch.sum(s * s, -1))
        dx, dy = prep.xy[g, 0] - pxf, prep.xy[g, 1] - pyf
        rho2d = FILTER_INV_SQUARE * (dx * dx + dy * dy)
        rho = torch.minimum(rho3d, rho2d)
        # low-pass-branch depth gradients freeze s (backward.cu:461-471)
        sd = torch.where((rho3d <= rho2d)[..., None], s, s.detach())
        depth = sd[..., 0] * Tw[0] + sd[..., 1] * Tw[1] + Tw[2]
        alpha = torch.clamp(opacity[g] * torch.exp(-0.5 * rho), max=ALPHA_MAX)
        ok = covered & (depth >= NEAR_N) & (alpha >= ALPHA_MIN) & ~done
        trig = ok & (T * (1 - alpha) < T_EPS)
        use = ok & ~trig
        w = torch.where(use, alpha * T, zero)
        m = FAR_N / (FAR_N - NEAR_N) * (1 - NEAR_N / torch.clamp(depth, min=NEAR_N))
        dist = dist + (m * m * (1 - T) + m2 - 2 * m * m1) * w
        m1 = m1 + m * w
        m2 = m2 + m * m * w
        med_hit = use & (T > 0.5)
        med_d = torch.where(med_hit, depth, med_d)
        med_i = torch.where(med_hit, rank, med_i)
        C = C + prep.color[g] * w[..., None]
        N = N + prep.normal_view[g] * w[..., None]
        D = D + depth * w
        R = R + refl[g] * w
        scope = scope | (use & scope_mask[g])
        ncon = torch.where(use, rank, ncon)
        T = torch.where(use, T * (1 - alpha), T)
        done = done | trig
    color = C + T[..., None] * bg
    others = torch.cat(
        [D[..., None], (1 - T)[..., None], N, med_d[..., None], dist[..., None],
         scope.to(dt)[..., None]],
        dim=-1,
    )
    return color, others, R, T, ncon
