"""Tile blending: through the tile kernel pair, or as the scan blend; and
image assembly.

Port of tpu_splat/raster/blend.py: `blend_kernel_path` (the JAX
`blend_pallas`), `assemble_image`, `tile_origins`, `_tiles_to_image`, and
the scan blend `blend` (`backend="xla"`). Given a `Mesh` (dist/mesh.py),
`blend` and `blend_kernel_path` split the (padded) tile axis over its
ranks: each rank blends its block of tiles against the replicated
Gaussians, the blocks are gathered into the whole image on every rank, the
Gaussians' gradient partials are summed and `gaussian_weights` is the max
of the ranks' (dist/collectives.py). The scan blend is the
reference compositing (forward.cu:258-489) rewritten for whole tile grids:
each tile's depth-sorted list is consumed `chunk` instances at a time, and
within a chunk the front-to-back "over" recurrence becomes exclusive
cumulative products of (1 - alpha) along the chunk axis, over [tiles,
chunk, 256 pixels] at once. Termination (T < 1e-4), the alpha skip, median
depth and distortion are kept with cumulative masks; the per-Gaussian max
weight is a scatter-max. It is plain PyTorch on the tensors' device,
differentiated by autograd; each chunk runs under
`torch.utils.checkpoint`, so the backward recomputes a chunk's [T, C, 256]
intermediates instead of keeping them all.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from tpu_splat_torch.core.device import stage
from tpu_splat_torch.core.segops import segment_max_sorted
from tpu_splat_torch.dist.collectives import (
    all_max_,
    axis_size,
    gather_rows,
    replicated,
    shard_rows,
)
from tpu_splat_torch.kernels import tile_blend as tb
from tpu_splat_torch.raster.config import (
    ALPHA_MAX,
    ALPHA_MIN,
    FAR_N,
    FILTER_INV_SQUARE,
    NEAR_N,
    T_EPS,
    TILE,
    TILE_PIX,
    RasterConfig,
    tile_grid,
)


class BlendOutput(NamedTuple):
    """Image-space outputs, channels-last [H, W, C]."""

    color: torch.Tensor  # [H,W,3] composited with background
    others: torch.Tensor  # [H,W,8] DEPTH,ALPHA,NORMALx3,MIDDEPTH,DISTORTION,MASK
    refl_map: torch.Tensor  # [H,W]
    final_T: torch.Tensor  # [H,W]
    n_contrib: torch.Tensor  # [H,W] int32
    gaussian_weights: torch.Tensor  # [P] max blend weight


def _tiles_to_image(x: torch.Tensor, tiles_y: int, tiles_x: int, H: int, W: int):
    """[T, 256, ...] tile-major -> [H, W, ...] image."""
    x = x[: tiles_y * tiles_x]
    trailing = x.shape[2:]
    x = x.reshape(tiles_y, tiles_x, TILE, TILE, *trailing)
    x = x.transpose(1, 2)
    x = x.reshape(tiles_y * TILE, tiles_x * TILE, *trailing)
    return x[:H, :W]


def tile_origins(height: int, width: int, pad_tiles_to: int = 1, device="cpu") -> torch.Tensor:
    """[T_padded, 2] int32 pixel origin (x, y) of each tile, row-major; the
    tiles that pad T to a multiple of `pad_tiles_to` lie far outside the
    image (nothing bins there)."""
    tiles_y, tiles_x = tile_grid(height, width)
    t_idx = torch.arange(tiles_y * tiles_x, dtype=torch.int32, device=device)
    org = torch.stack([(t_idx % tiles_x) * TILE, (t_idx // tiles_x) * TILE], dim=-1)
    pad = (-org.shape[0]) % pad_tiles_to
    if pad:
        org = torch.cat([org, torch.full((pad, 2), 1 << 22, dtype=torch.int32, device=device)])
    return org


def assemble_image(out_px, tiles_y, tiles_x, height, width, bg, train_shape: bool):
    """[T, 16, 256] kernel output -> (color, others[8], refl, final_T,
    n_contrib) image-space maps through one tile->image permute.

    train_shape: the kernel skipped the distortion/median/M1/M2 channels, so
    only the 10 live channels are permuted and MED/DIST/NCON are served as
    zeros."""
    if train_shape:
        keep = torch.cat(
            [
                out_px[:, tb.O_COL : tb.O_DIST],  # color 3, T, depth, refl
                out_px[:, tb.O_NRM : tb.O_NRM + 3],
                out_px[:, tb.O_SCOPE : tb.O_SCOPE + 1],
            ],
            dim=1,
        )  # [T, 10, L]
        img = _tiles_to_image(keep.transpose(1, 2), tiles_y, tiles_x, height, width)
        Tf = img[..., 3:4]
        zero1 = torch.zeros_like(Tf)
        color = img[..., 0:3] + Tf * bg[None, None, :]
        others = torch.cat(
            [img[..., 4:5], 1.0 - Tf, img[..., 6:9], zero1, zero1, img[..., 9:10]],
            dim=-1,
        )
        return (
            color, others, img[..., 5], img[..., 3],
            torch.zeros(img.shape[:2], dtype=torch.int32, device=img.device),
        )
    imgall = _tiles_to_image(out_px.transpose(1, 2), tiles_y, tiles_x, height, width)
    Tf_img = imgall[..., tb.O_T : tb.O_T + 1]
    color_img = imgall[..., tb.O_COL : tb.O_COL + 3] + Tf_img * bg[None, None, :]
    others = torch.cat(
        [
            imgall[..., tb.O_DEPTH : tb.O_DEPTH + 1],
            1.0 - Tf_img,
            imgall[..., tb.O_NRM : tb.O_NRM + 3],
            imgall[..., tb.O_MED : tb.O_MED + 1],
            imgall[..., tb.O_DIST : tb.O_DIST + 1],
            imgall[..., tb.O_SCOPE : tb.O_SCOPE + 1],
        ],
        dim=-1,
    )
    return (
        color_img, others, imgall[..., tb.O_REFL], imgall[..., tb.O_T],
        imgall[..., tb.O_NCON].to(torch.int32),
    )


def blend_kernel_path(
    binned,
    hom: torch.Tensor,
    xy: torch.Tensor,
    opacity: torch.Tensor,
    normal_view: torch.Tensor,
    color: torch.Tensor,
    refl: torch.Tensor,
    scope_mask: torch.Tensor,
    bg: torch.Tensor,
    height: int,
    width: int,
    train_shape: bool = False,
    bf16_grads: bool = False,
    bf16_feats: bool = False,
    collect_weights: bool = True,
    mesh=None,
    axis: str = "tiles",
) -> BlendOutput:
    """Blend through the tile kernel pair (counterpart of the JAX
    `blend_pallas`): pack the aligned instance slab, run the differentiable
    sweep (`tile_blend.blend_kernel`), assemble the image, and
    (collect_weights) reduce the per-instance max weights to per-Gaussian
    ones. Gradients flow to hom, xy, opacity, normal_view, color and refl:
    the kernel's hand-derived backward, then the sort-regroup of the slab
    gather (bf16_grads packs its rows in bf16 pairs).

    With a mesh (binned with pad_tiles_to = its size), each rank runs the
    kernel pair on its block of tiles against the replicated slab; the
    slab's gradient partials are summed and the per-instance max weights
    maxed across the ranks. `rasterize` never takes this branch: its kernel
    path with a mesh goes to `raster.sharded.rasterize_tiles_sharded`, as the
    JAX package's does; only the multi-rank tests call it."""
    tiles_y, tiles_x = tile_grid(height, width)
    with stage("pack_features"):
        feats = tb.pack_features(
            binned.aligned_gid, binned.aligned_valid,
            hom, xy, opacity, normal_view, color, refl, scope_mask,
            group_key=binned.aligned_rank, rank_of=binned.rank_of,
            seg_start=binned.seg_start, seg_end=binned.seg_end,
            bf16_grads=bf16_grads, bf16_feats=bf16_feats,
        )
        n_shards = 1 if mesh is None else axis_size(mesh, axis)
        org = tile_origins(height, width, pad_tiles_to=n_shards, device=hom.device)
        counts = binned.tile_counts  # [T]: the tiles a mesh's padding added are empty
        counts = torch.cat([counts, counts.new_zeros(org.shape[0] - counts.shape[0])])
        index = [binned.aligned_starts, counts, org[:, 0].contiguous(), org[:, 1].contiguous()]
    kw = dict(full_grads=not train_shape, packed_feats=bf16_feats, collect_wmax=collect_weights)
    with stage("tile_blend_forward"):
        if mesh is None:
            out_px, wmax = tb.blend_kernel(feats, *index, **kw)
        else:
            (feats,) = replicated(mesh, feats)
            out_l, wmax = tb.blend_kernel(feats, *(shard_rows(mesh, t) for t in index), **kw)
            out_px = gather_rows(mesh, out_l)
            wmax = wmax.clone()
            all_max_(mesh, wmax)
    with stage("assemble_image"):
        color_img, others, refl_img, T_img, ncon_img = assemble_image(
            out_px, tiles_y, tiles_x, height, width, bg, train_shape=train_shape,
        )
    if collect_weights:
        # per-Gaussian max blend weight: a two-key sort by (rank, wmax) puts
        # each rank run's max at its analytic end; un-rank with a gather
        with stage("gaussian_weights"):
            gw_by_rank = segment_max_sorted(
                torch.where(binned.aligned_valid, wmax, 0.0),
                binned.aligned_rank, binned.seg_start, binned.seg_end,
            )
            gw = gw_by_rank[binned.rank_of.long()]
    else:
        # serving: the densify stat is never read (forward.cu:457-459)
        gw = torch.zeros((hom.shape[0],), dtype=torch.float32, device=hom.device)
    return BlendOutput(
        color=color_img,
        others=others,
        refl_map=refl_img,
        final_T=T_img,
        n_contrib=ncon_img,
        gaussian_weights=gw,
    )


blend_pallas = blend_kernel_path  # name of the JAX counterpart


# -- the scan blend (backend="xla") ---------------------------------------------

class BlendCarry(NamedTuple):
    T: torch.Tensor  # [T, L] transmittance
    done: torch.Tensor  # [T, L] bool, terminated
    color: torch.Tensor  # [T, L, 3]
    normal: torch.Tensor  # [T, L, 3] view-space
    depth: torch.Tensor  # [T, L] expected depth accumulator
    refl: torch.Tensor  # [T, L]
    dist: torch.Tensor  # [T, L] distortion accumulator
    m1: torch.Tensor  # [T, L]
    m2: torch.Tensor  # [T, L]
    scope: torch.Tensor  # [T, L] env-scope mask hit
    median_depth: torch.Tensor  # [T, L]
    n_contrib: torch.Tensor  # [T, L] int32 (1-based last contributor)
    median_idx: torch.Tensor  # [T, L] int32 (1-based median contributor)
    gw: torch.Tensor  # [P] max blend weight per Gaussian


class GaussFeats(NamedTuple):
    """Per-Gaussian blending attributes."""

    hom: torch.Tensor  # [P,3,3]
    xy: torch.Tensor  # [P,2]
    opacity: torch.Tensor  # [P]
    normal_view: torch.Tensor  # [P,3]
    color: torch.Tensor  # [P,3]
    refl: torch.Tensor  # [P]
    scope_mask: torch.Tensor  # [P] bool


def _excl_cumprod(x: torch.Tensor, dim: int) -> torch.Tensor:
    cp = torch.cumprod(x, dim)
    one = torch.ones_like(cp.narrow(dim, 0, 1))
    return torch.cat([one, cp.narrow(dim, 0, x.shape[dim] - 1)], dim)


def _excl_cumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    return torch.cumsum(x, dim) - x


def _chunk(feats: GaussFeats, hom64, xy64, org64, pixx, pixy, gk_base, carry: tuple, ids,
           vmask):
    """One chunk of C instances of every tile (tpu_splat/raster/blend.py:
    _blend_scan.body). ids, vmask [T, C]; hom64, xy64 the homographies and
    centres in float64; org64 [T, 1, 2] the tile origins; pixx, pixy
    [1, 1, L] the pixel offsets within a tile; gk_base [1, C, 1] the
    chunk's 1-based instance indices.

    The intersection is evaluated in tile-local pixel coordinates: each
    (tile, instance) homography is moved to the tile's origin in float64
    (Tu - ox Tw, Tv - oy Tw) and rounded once, so the per-pixel products
    no longer cancel terms as large as the absolute pixel coordinates, as
    the JAX scan's `px Tw - Tu` does; in exact arithmetic the two are the
    same. The gradients of the shift accumulate into hom64 and xy64 in
    float64."""
    c = BlendCarry(*carry)
    dt = feats.opacity.dtype
    h64 = hom64[ids]  # [T,C,3,3]
    ox, oy = org64[..., 0:1], org64[..., 1:2]  # [T,1,1]
    Tw64 = h64[..., 2, :]
    Tu = (h64[..., 0, :] - ox * Tw64).to(dt)
    Tv = (h64[..., 1, :] - oy * Tw64).to(dt)
    Tw = Tw64.to(dt)
    g_xy = (xy64[ids] - org64).to(dt)  # [T,C,2] tile-local
    opa = feats.opacity[ids]  # [T,C]
    nrm = feats.normal_view[ids]  # [T,C,3]
    col = feats.color[ids]  # [T,C,3]
    rfl = feats.refl[ids]  # [T,C]
    scp = feats.scope_mask[ids]  # [T,C]

    def comp(v, i):
        return v[..., i : i + 1]  # [T,C,1] against [T,1,L]

    # ray-splat intersection (2DGS Eqs. 8-10; forward.cu:363-394)
    k0 = pixx * comp(Tw, 0) - comp(Tu, 0)
    k1 = pixx * comp(Tw, 1) - comp(Tu, 1)
    k2 = pixx * comp(Tw, 2) - comp(Tu, 2)
    l0 = pixy * comp(Tw, 0) - comp(Tv, 0)
    l1 = pixy * comp(Tw, 1) - comp(Tv, 1)
    l2 = pixy * comp(Tw, 2) - comp(Tv, 2)
    p0 = k1 * l2 - k2 * l1
    p1 = k2 * l0 - k0 * l2
    p2 = k0 * l1 - k1 * l0
    unstable = torch.abs(p2) < 1e-4
    inv_p2 = 1.0 / torch.where(unstable, torch.ones_like(p2), p2)
    zero = torch.zeros_like(p2)
    sx = torch.where(unstable, zero, p0 * inv_p2)
    sy = torch.where(unstable, zero, p1 * inv_p2)
    rho3d = torch.where(unstable, torch.full_like(p2, 1e8), sx * sx + sy * sy)
    dx = comp(g_xy, 0) - pixx
    dy = comp(g_xy, 1) - pixy
    rho2d = FILTER_INV_SQUARE * (dx * dx + dy * dy)
    rho = torch.minimum(rho3d, rho2d)
    # the reference backward's depth-value gradient (backward.cu:461-471):
    # in the low-pass branch (rho2d < rho3d) s is held constant, so depth
    # gradients reach Tw only as dL_dz * (s.x, s.y, 1)
    use3 = rho3d <= rho2d
    sxd = torch.where(use3, sx, sx.detach())
    syd = torch.where(use3, sy, sy.detach())
    depth = sxd * comp(Tw, 0) + syd * comp(Tw, 1) + comp(Tw, 2)

    G = torch.exp(-0.5 * rho)
    alpha = torch.clamp(opa[..., None] * G, max=ALPHA_MAX)  # [T,C,L]
    accept = (depth >= NEAR_N) & (alpha >= ALPHA_MIN) & vmask[..., None] & ~c.done[:, None, :]
    a_eff = torch.where(accept, alpha, zero)

    prefix = _excl_cumprod(1.0 - a_eff, 1)  # [T,C,L]
    T_before = c.T[:, None, :] * prefix
    trigger = accept & (T_before * (1.0 - alpha) < T_EPS)
    term_excl = _excl_cumsum(trigger.to(torch.int32), 1) > 0
    contrib = accept & ~term_excl & ~trigger
    w = torch.where(contrib, alpha * T_before, zero)  # [T,C,L]

    a_contrib = torch.where(contrib, alpha, zero)
    T_out = c.T * torch.prod(1.0 - a_contrib, 1)
    done_out = c.done | trigger.any(1)

    color_out = c.color + torch.einsum("tcl,tck->tlk", w, col)
    normal_out = c.normal + torch.einsum("tcl,tck->tlk", w, nrm)
    depth_out = c.depth + torch.sum(depth * w, 1)
    refl_out = c.refl + torch.sum(rfl[..., None] * w, 1)
    scope_out = c.scope | (scp[..., None] & contrib).any(1)

    # depth distortion (2DGS appendix; forward.cu:419-427)
    safe_depth = torch.clamp(depth, min=NEAR_N)
    m = FAR_N / (FAR_N - NEAR_N) * (1.0 - NEAR_N / safe_depth)
    A = 1.0 - T_before
    mw = m * w
    m2w = m * m * w
    M1b = c.m1[:, None, :] + _excl_cumsum(mw, 1)
    M2b = c.m2[:, None, :] + _excl_cumsum(m2w, 1)
    dist_out = c.dist + torch.sum((m * m * A + M2b - 2.0 * m * M1b) * w, 1)
    m1_out = c.m1 + torch.sum(mw, 1)
    m2_out = c.m2 + torch.sum(m2w, 1)

    # median depth: the last contributor with T_before > 0.5 (forward.cu:429-433)
    izero = torch.zeros((), dtype=torch.int32, device=ids.device)
    med_cond = contrib & (T_before > 0.5)
    med_rank = torch.where(med_cond, gk_base, izero).amax(1)  # [T,L]
    has_med = med_rank > 0
    sel = med_cond & (gk_base == med_rank[:, None, :])
    med_depth_new = torch.sum(torch.where(sel, depth, zero), 1)
    median_depth_out = torch.where(has_med, med_depth_new, c.median_depth)
    median_idx_out = torch.maximum(c.median_idx, med_rank)
    n_contrib_out = torch.maximum(c.n_contrib, torch.where(contrib, gk_base, izero).amax(1))

    # per-Gaussian max blend weight (replaces atomicExch, forward.cu:457-459)
    w_inst = w.detach().amax(2)  # [T,C]
    gw_out = c.gw.scatter_reduce(0, ids.reshape(-1).long(), w_inst.reshape(-1), "amax")
    return (T_out, done_out, color_out, normal_out, depth_out, refl_out, dist_out, m1_out,
            m2_out, scope_out, median_depth_out, n_contrib_out, median_idx_out, gw_out)


def _blend_scan(
    tile_gid: torch.Tensor,  # [T, K]
    tile_mask: torch.Tensor,  # [T, K]
    org_xy: torch.Tensor,  # [T, 2] pixel origin of each tile
    feats: GaussFeats,
    cfg: RasterConfig,
) -> BlendCarry:
    n_tiles = tile_gid.shape[0]
    P_ = feats.opacity.shape[0]
    C, S, L = cfg.chunk, cfg.n_chunks, TILE_PIX
    dev = tile_gid.device
    # dtype follows the inputs (float32 in production, float64 in the
    # reference-oracle tests)
    dt = feats.opacity.dtype
    lane = torch.arange(L, dtype=torch.int32, device=dev)
    pixx = (lane % TILE).to(dt)[None, None, :]
    pixy = (lane // TILE).to(dt)[None, None, :]
    org64 = org_xy.to(torch.float64)[:, None, :]  # [T,1,2]
    hom64, xy64 = feats.hom.to(torch.float64), feats.xy.to(torch.float64)
    ids_s = tile_gid.reshape(n_tiles, S, C).long()
    mask_s = tile_mask.reshape(n_tiles, S, C)
    gk = torch.arange(1, C + 1, dtype=torch.int32, device=dev)[None, :, None]

    z = lambda *shape: torch.zeros(shape, dtype=dt, device=dev)
    carry = BlendCarry(
        T=torch.ones((n_tiles, L), dtype=dt, device=dev),
        done=torch.zeros((n_tiles, L), dtype=torch.bool, device=dev),
        color=z(n_tiles, L, 3), normal=z(n_tiles, L, 3), depth=z(n_tiles, L),
        refl=z(n_tiles, L), dist=z(n_tiles, L), m1=z(n_tiles, L), m2=z(n_tiles, L),
        scope=torch.zeros((n_tiles, L), dtype=torch.bool, device=dev),
        median_depth=z(n_tiles, L),
        n_contrib=torch.zeros((n_tiles, L), dtype=torch.int32, device=dev),
        median_idx=torch.zeros((n_tiles, L), dtype=torch.int32, device=dev),
        gw=z(P_),
    )
    grad = torch.is_grad_enabled() and any(
        isinstance(x, torch.Tensor) and x.requires_grad for x in feats)

    def body(ids, vmask, gk_base, *c):
        return _chunk(feats, hom64, xy64, org64, pixx, pixy, gk_base, c, ids, vmask)

    for s in range(S):
        args = (ids_s[:, s], mask_s[:, s], gk + s * C, *carry)
        if grad:
            # the backward recomputes the chunk (JAX: jax.checkpoint(body))
            out = checkpoint(body, *args, use_reentrant=False)
        else:
            out = body(*args)
        carry = BlendCarry(*out)
    return carry


def blend(
    tile_gid: torch.Tensor,  # [T, K] (T padded to a multiple of the mesh size)
    tile_mask: torch.Tensor,  # [T, K]
    hom: torch.Tensor,  # [P,3,3]
    xy: torch.Tensor,  # [P,2]
    opacity: torch.Tensor,  # [P]
    normal_view: torch.Tensor,  # [P,3]
    color: torch.Tensor,  # [P,3]
    refl: torch.Tensor,  # [P]
    scope_mask: torch.Tensor,  # [P] bool
    bg: torch.Tensor,  # [3]
    height: int,
    width: int,
    cfg: RasterConfig,
    mesh=None,
    axis: str = "tiles",
) -> BlendOutput:
    """The scan blend (tpu_splat/raster/blend.py:blend). Differentiable in
    hom, xy, opacity, normal_view, color and refl; gaussian_weights is
    detached. With a mesh (binned with pad_tiles_to = its size), each rank
    scans its block of the tile axis; gaussian_weights is the max of the
    ranks' partials."""
    tiles_y, tiles_x = tile_grid(height, width)
    n_shards = 1 if mesh is None else axis_size(mesh, axis)
    org = tile_origins(height, width, pad_tiles_to=n_shards, device=hom.device)
    if mesh is None:
        feats = GaussFeats(hom=hom, xy=xy, opacity=opacity, normal_view=normal_view,
                           color=color, refl=refl, scope_mask=scope_mask)
        final = _blend_scan(tile_gid, tile_mask, org, feats, cfg)
    else:
        feats = GaussFeats(*replicated(mesh, hom, xy, opacity, normal_view, color, refl),
                           scope_mask=scope_mask)
        local = _blend_scan(*(shard_rows(mesh, t) for t in (tile_gid, tile_mask, org)),
                            feats, cfg)
        gw = local.gw.clone()
        all_max_(mesh, gw)
        final = BlendCarry(*(gather_rows(mesh, x) for x in local[:-1]), gw=gw)

    img = lambda x: _tiles_to_image(x, tiles_y, tiles_x, height, width)
    out_color = img(final.color + final.T[..., None] * bg[None, None, :])
    others = torch.cat(
        [
            img(final.depth)[..., None],
            img(1.0 - final.T)[..., None],
            img(final.normal),
            img(final.median_depth)[..., None],
            img(final.dist)[..., None],
            img(final.scope.to(final.T.dtype))[..., None],
        ],
        dim=-1,
    )
    return BlendOutput(
        color=out_color,
        others=others,
        refl_map=img(final.refl),
        final_T=img(final.T),
        n_contrib=img(final.n_contrib),
        gaussian_weights=final.gw.detach(),
    )
