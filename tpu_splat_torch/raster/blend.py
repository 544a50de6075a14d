"""Tile blending through the tile kernel pair, and image assembly.

Port of the kernel path of tpu_splat/raster/blend.py (`blend_pallas`,
differentiable, `assemble_image`, `tile_origins`, `_tiles_to_image`). The
XLA scan blend of the JAX package is not ported.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from tpu_splat_torch.core.device import stage
from tpu_splat_torch.core.segops import segment_max_sorted
from tpu_splat_torch.kernels import tile_blend as tb
from tpu_splat_torch.raster.config import TILE, tile_grid


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


def tile_origins(height: int, width: int, device="cpu") -> torch.Tensor:
    """[T, 2] int32 pixel origin (x, y) of each tile, row-major."""
    tiles_y, tiles_x = tile_grid(height, width)
    t_idx = torch.arange(tiles_y * tiles_x, dtype=torch.int32, device=device)
    return torch.stack([(t_idx % tiles_x) * TILE, (t_idx // tiles_x) * TILE], dim=-1)


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
) -> BlendOutput:
    """Blend through the tile kernel pair (counterpart of the JAX
    `blend_pallas`): pack the aligned instance slab, run the differentiable
    sweep (`tile_blend.blend_kernel`), assemble the image, and
    (collect_weights) reduce the per-instance max weights to per-Gaussian
    ones. Gradients flow to hom, xy, opacity, normal_view, color and refl:
    the kernel's hand-derived backward, then the sort-regroup of the slab
    gather (bf16_grads packs its rows in bf16 pairs)."""
    tiles_y, tiles_x = tile_grid(height, width)
    with stage("pack_features"):
        feats = tb.pack_features(
            binned.aligned_gid, binned.aligned_valid,
            hom, xy, opacity, normal_view, color, refl, scope_mask,
            group_key=binned.aligned_rank, rank_of=binned.rank_of,
            seg_start=binned.seg_start, seg_end=binned.seg_end,
            bf16_grads=bf16_grads, bf16_feats=bf16_feats,
        )
        org = tile_origins(height, width, device=hom.device)
    with stage("tile_blend_forward"):
        out_px, wmax = tb.blend_kernel(
            feats, binned.aligned_starts, binned.tile_counts,
            org[:, 0].contiguous(), org[:, 1].contiguous(),
            full_grads=not train_shape, packed_feats=bf16_feats,
            collect_wmax=collect_weights,
        )
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
