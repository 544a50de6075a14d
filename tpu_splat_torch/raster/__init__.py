"""Differentiable rasterizer: preprocess -> bin -> blend (port of
tpu_splat/raster/__init__.py). Surfel (2DGS) or volumetric (3DGS EWA)
splats, blended by the tile kernels or by the scan blend; differentiable in
the Gaussian attributes and the `screen_offset` densify probe. Given a
`Mesh`, the tile grid is split over its ranks (raster/sharded.py for the
tile kernels, the scan blend's mesh branch otherwise)."""
from __future__ import annotations

from typing import NamedTuple

import torch

from tpu_splat_torch.core.device import backward_edge, full_precision_matmul, stage
from tpu_splat_torch.core.graphics import Camera
from tpu_splat_torch.dist.collectives import axis_size
from tpu_splat_torch.raster.config import RasterConfig
from tpu_splat_torch.raster.preprocess import preprocess
from tpu_splat_torch.raster.binning import bin_gaussians
from tpu_splat_torch.raster.blend import blend, blend_kernel_path
from tpu_splat_torch.raster.volumetric import preprocess_volumetric
from tpu_splat_torch.raster.sharded import rasterize_tiles_sharded

# allmap channel offsets (reference auxiliary.h:22-28)
DEPTH_CH = 0
ALPHA_CH = 1
NORMAL_CH = slice(2, 5)
MIDDEPTH_CH = 5
DISTORTION_CH = 6
MASK_CH = 7


class RasterOutput(NamedTuple):
    color: torch.Tensor  # [H,W,3] base color composited over bg
    others: torch.Tensor  # [H,W,8] allmap (channel offsets above)
    refl_map: torch.Tensor  # [H,W]
    radii: torch.Tensor  # [P] int32 screen radii (0 = culled)
    gaussian_weights: torch.Tensor  # [P] max blend weight
    final_T: torch.Tensor  # [H,W]
    n_contrib: torch.Tensor  # [H,W] int32
    num_instances: torch.Tensor  # [] overflow diagnostic
    max_area: torch.Tensor  # [] overflow diagnostic
    tile_counts: torch.Tensor  # [T] overflow diagnostic
    pad_overflow: torch.Tensor  # [] pads beyond cfg.pad_per_tile budget


def rasterize(
    means3d: torch.Tensor,
    scales: torch.Tensor,
    rotations: torch.Tensor,
    opacity: torch.Tensor,  # [P] post-activation
    refl: torch.Tensor,  # [P] post-activation
    camera: Camera,
    bg: torch.Tensor,
    cfg: RasterConfig,
    sh: torch.Tensor | None = None,
    sh_degree: int = 0,
    colors: torch.Tensor | None = None,
    scope_mask: torch.Tensor | None = None,
    scale_modifier: float = 1.0,
    screen_offset: torch.Tensor | None = None,
    hom_precomp: torch.Tensor | None = None,
    alive: torch.Tensor | None = None,
    mesh=None,
    mesh_axis: str = "tiles",
    mode: str = "surfel",
    normals: torch.Tensor | None = None,
    antialiasing: bool = False,
    collect_weights: bool = True,
) -> RasterOutput:
    """mode="surfel": 2DGS disks (scales [P,2], the production path).
    mode="volumetric": classic 3DGS EWA splats (scales [P,3]), the
    per-Gaussian input `normals` blended (default +z); `antialiasing`
    scales opacity by the Mip-Splatting factor; `screen_offset` is
    3DGS's means2D probe; it takes neither `hom_precomp` nor
    `cfg.tight_culling` (whose per-column conic is the surfels').
    `cfg.backend` picks the blend: the tile kernels ("auto", "pallas") or
    the scan blend ("xla").
    With a `mesh` every rank of it calls this on the same replicated
    inputs and gets the whole frame; the tile kernels then run on its slab
    of tile rows (`rasterize_tiles_sharded`), the scan blend on its block
    of tiles. Runs on the device the inputs live on."""
    if mode not in ("surfel", "volumetric"):
        raise ValueError(f"mode must be 'surfel' or 'volumetric', not {mode!r}")
    if mode == "volumetric" and hom_precomp is not None:
        raise ValueError("hom_precomp is a surfel homography: mode='volumetric' takes none")
    if mode == "volumetric" and cfg.tight_culling:
        raise ValueError("tight culling bins by the surfel conic: volumetric Gaussians "
                         "bin by their rect (tight_culling=False)")
    full_precision_matmul()
    H, W = camera.height, camera.width
    P = means3d.shape[0]
    if scope_mask is None:
        scope_mask = torch.ones((P,), dtype=torch.bool, device=means3d.device)

    with stage("preprocess"):
        # the preprocess VJP spans from its outputs' gradients to its inputs'
        # (opacity among them: the volumetric preprocess rescales it)
        means3d, scales, rotations, opacity, sh, screen_offset, hom_precomp, normals = (
            backward_edge("preprocess_vjp", "end", means3d, scales, rotations, opacity, sh,
                          screen_offset, hom_precomp, normals))
        if mode == "volumetric":
            if normals is None:
                normals = torch.zeros((P, 3), dtype=means3d.dtype, device=means3d.device)
                normals[:, 2] = 1.0
            prep, opa_scale = preprocess_volumetric(
                means3d,
                scales,
                rotations,
                normals,
                camera.world_view,
                camera.full_proj,
                camera.camera_center,
                H,
                W,
                camera.tanfovx,
                camera.tanfovy,
                sh=sh,
                sh_degree=sh_degree,
                colors=colors,
                scale_modifier=scale_modifier,
                antialiasing=antialiasing,
                screen_offset=screen_offset,
            )
            opacity = opacity * opa_scale
        else:
            prep = preprocess(
                means3d,
                scales,
                rotations,
                camera.world_view,
                camera.full_proj,
                camera.camera_center,
                H,
                W,
                sh=sh,
                sh_degree=sh_degree,
                colors=colors,
                scale_modifier=scale_modifier,
                screen_offset=screen_offset,
                hom_precomp=hom_precomp,
                opacity=opacity if cfg.opacity_rect else None,
                circular_rect=cfg.circular_rect,
            )
        hom, xy, normal_view, color, opacity = backward_edge(
            "preprocess_vjp", "start", prep.hom, prep.xy, prep.normal_view, prep.color, opacity
        )
        prep = prep._replace(hom=hom, xy=xy, normal_view=normal_view, color=color)
        if alive is not None:
            valid = prep.valid & alive
            prep = prep._replace(
                valid=valid,
                radius=torch.where(valid, prep.radius, torch.zeros_like(prep.radius)),
                tiles_touched=torch.where(
                    valid, prep.tiles_touched, torch.zeros_like(prep.tiles_touched)
                ),
            )
    use_kernel = cfg.use_kernel()
    if use_kernel and mesh is not None:
        # binning, packing and the kernel pair per rank on its tile slab; the
        # per-Gaussian gradient sum is the only collective of the backward
        out, *diag = rasterize_tiles_sharded(
            prep, opacity, refl, scope_mask, bg, H, W, cfg, mesh=mesh, axis=mesh_axis)
    else:
        n_shards = 1 if mesh is None else axis_size(mesh, mesh_axis)
        with stage("binning"):
            binned = bin_gaussians(prep, H, W, cfg, pad_tiles_to=n_shards, aligned=use_kernel)
        diag = binned.num_instances, binned.max_area, binned.tile_counts, binned.pad_overflow
        if use_kernel:
            out = blend_kernel_path(
                binned,
                prep.hom,
                prep.xy,
                opacity,
                prep.normal_view,
                prep.color,
                refl,
                scope_mask,
                bg,
                H,
                W,
                train_shape=cfg.grad_channels == "train",
                bf16_grads=cfg.bf16_grads,
                bf16_feats=cfg.bf16_feats,
                collect_weights=collect_weights,
            )
        else:
            with stage("scan_blend"):
                out = blend(
                    binned.tile_gid,
                    binned.tile_mask,
                    prep.hom,
                    prep.xy,
                    opacity,
                    prep.normal_view,
                    prep.color,
                    refl,
                    scope_mask,
                    bg,
                    H,
                    W,
                    cfg,
                    mesh=mesh,
                    axis=mesh_axis,
                )
            if not collect_weights:
                # as the kernel path's serving frame: densify stats off
                out = out._replace(gaussian_weights=torch.zeros_like(out.gaussian_weights))
    num_instances, max_area, tile_counts, pad_overflow = diag
    return RasterOutput(
        color=out.color,
        others=out.others,
        refl_map=out.refl_map,
        radii=prep.radius,
        gaussian_weights=out.gaussian_weights,
        final_T=out.final_T,
        n_contrib=out.n_contrib,
        num_instances=num_instances,
        max_area=max_area,
        tile_counts=tile_counts,
        pad_overflow=pad_overflow,
    )
