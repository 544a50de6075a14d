"""Tile-slab rasterization over a mesh (port of tpu_splat/raster/sharded.py).

Each rank of the mesh owns a slab of Rh = ceil(tiles_y / n) tile rows and:
- clips every Gaussian's tile rect to its slab (cheap [P] elementwise work
  on the replicated preprocess output); Gaussians clipped out are marked
  invalid, not merely given zero area, since the expansion decode needs the
  emitting runs to form a contiguous prefix of the depth order;
- bins, sorts and packs only the instances overlapping its slab, at a
  per-rank capacity of max_instances / n;
- runs the tile kernel pair on its slab with the global tile origins;
- regroups its instance gradients into per-Gaussian partials, which one
  all-reduce sums in the backward (`dist.collectives.replicated`).

The slabs are gathered into the whole image on every rank, so the work
after the rasterizer (reflection, loss) sees the frame the single-device
path renders. Slab rows past tiles_y are padding: nothing bins there and
the image is cropped. Tight culling falls back to rect binning under
sharding (its conic tables are in global pixel space), with a warning.
"""
from __future__ import annotations

import dataclasses
import warnings

import torch

from tpu_splat_torch.core.device import stage
from tpu_splat_torch.core.segops import segment_max_sorted
from tpu_splat_torch.dist.collectives import all_max_, axis_size, gather_rows, replicated
from tpu_splat_torch.kernels import tile_blend as tb
from tpu_splat_torch.raster.binning import bin_gaussians
from tpu_splat_torch.raster.blend import BlendOutput, assemble_image
from tpu_splat_torch.raster.config import TILE, RasterConfig, tile_grid
from tpu_splat_torch.raster.preprocess import Preprocessed


def rasterize_tiles_sharded(
    prep: Preprocessed,
    opacity: torch.Tensor,
    refl: torch.Tensor,
    scope_mask: torch.Tensor,
    bg: torch.Tensor,
    height: int,
    width: int,
    cfg: RasterConfig,
    mesh,
    axis: str = "tiles",
):
    """-> (BlendOutput, num_instances, max_area, tile_counts, pad_overflow),
    the same on every rank.

    num_instances is in global capacity units: the busiest rank's count
    times n, so that check_growth's comparison against cfg.max_instances
    keeps its meaning (growth when any rank nears its local capacity)."""
    n = axis_size(mesh, axis)
    tiles_y, tiles_x = tile_grid(height, width)
    Rh = -(-tiles_y // n)  # tile rows per rank
    if cfg.max_instances % n:
        raise ValueError(
            f"max_instances {cfg.max_instances} must divide by the mesh size {n} for "
            "sharded binning"
        )
    if cfg.tight_culling:
        warnings.warn(
            "tight_culling does not compose with sharded tile-slab binning; falling back "
            "to the rect pipeline on every shard",
            stacklevel=3,
        )
    cfg_local = dataclasses.replace(cfg, max_instances=cfg.max_instances // n,
                                    tight_culling=False, max_columns=0)
    full_grads = cfg.grad_channels != "train"

    r0 = mesh.rank * Rh
    rmin, rmax = prep.rect_min, prep.rect_max
    ry0 = torch.clamp(rmin[:, 1] - r0, 0, Rh)
    ry1 = torch.clamp(rmax[:, 1] - r0, 0, Rh)
    rw = torch.clamp(rmax[:, 0] - rmin[:, 0], min=0)
    area = torch.where(prep.valid, rw * torch.clamp(ry1 - ry0, min=0), 0).to(torch.int32)
    prep_l = prep._replace(
        valid=prep.valid & (area > 0),
        rect_min=torch.stack([rmin[:, 0], ry0], dim=1),
        rect_max=torch.stack([rmax[:, 0], ry1], dim=1),
        tiles_touched=area,
    )
    with stage("binning"):
        # a slab is shorter than the image, never wider: bin_gaussians' check
        # of the grid against its rect word's 10-bit fields covers it
        binned = bin_gaussians(prep_l, Rh * TILE, width, cfg_local, aligned=True)
    hom, xy, opa, nrm, col, rfl = replicated(
        mesh, prep.hom, prep.xy, opacity, prep.normal_view, prep.color, refl)
    dev = hom.device
    with stage("pack_features"):
        feats = tb.pack_features(
            binned.aligned_gid, binned.aligned_valid, hom, xy, opa, nrm, col, rfl,
            scope_mask, group_key=binned.aligned_rank, rank_of=binned.rank_of,
            seg_start=binned.seg_start, seg_end=binned.seg_end,
            bf16_grads=cfg.bf16_grads, bf16_feats=cfg.bf16_feats,
        )
        t_idx = torch.arange(r0 * tiles_x, (r0 + Rh) * tiles_x, dtype=torch.int32, device=dev)
        org_x, org_y = (t_idx % tiles_x) * TILE, (t_idx // tiles_x) * TILE
    with stage("tile_blend_forward"):
        out_l, wmax = tb.blend_kernel(
            feats, binned.aligned_starts, binned.tile_counts, org_x, org_y,
            full_grads=full_grads, packed_feats=cfg.bf16_feats,
        )
    with stage("gaussian_weights"):
        gw = segment_max_sorted(
            torch.where(binned.aligned_valid, wmax, 0.0),
            binned.aligned_rank, binned.seg_start, binned.seg_end,
        )[binned.rank_of.long()]
        diag = torch.stack([binned.num_instances, binned.max_area,
                            binned.pad_overflow]).to(torch.int64)
        all_max_(mesh, gw, diag)
    with stage("slab_gather"):
        out_px = gather_rows(mesh, out_l)
        counts = gather_rows(mesh, binned.tile_counts)
    with stage("assemble_image"):
        color, others, refl_img, T_img, ncon = assemble_image(
            out_px, Rh * n, tiles_x, height, width, bg, train_shape=not full_grads)
    out = BlendOutput(color=color, others=others, refl_map=refl_img, final_T=T_img,
                      n_contrib=ncon, gaussian_weights=gw)
    return out, diag[0] * n, diag[1], counts[: tiles_y * tiles_x], diag[2]
