"""TSDF mesh extraction CLI (port of tpu_splat/scripts/extract_mesh.py;
restores the 2DGS mesh export the reference stripped; role of
utils/mesh_utils.py + utils/mcube_utils.py).

    python -m tpu_splat_torch.scripts.extract_mesh -m <model_dir> [--mesh_res 512]

Renders every train view with the full render() on the card, TSDF-fuses the
surf_depth maps over the scene bounds there, triangulates the zero level
set and writes <model>/mesh/fuse.ply.
"""
from __future__ import annotations

import os

import numpy as np


def main(argv=None, device: str = "cuda"):
    """The JAX CLI's flags and defaults; `device` is where the model renders
    and the grid is fused (the tests pass "cpu"). -> 0."""
    import torch

    from tpu_splat_torch.config import build_parser, get_combined_args
    from tpu_splat_torch.core.device import resolve_device
    from tpu_splat_torch.data.scene import Scene
    from tpu_splat_torch.eval.mesh import GaussianExtractor, save_mesh_ply
    from tpu_splat_torch.raster.config import RasterConfig
    from tpu_splat_torch.scripts.render import load_iteration

    parser = build_parser(fill_none_model=True)
    parser.add_argument("--iteration", type=int, default=-1)
    parser.add_argument("--mesh_res", type=int, default=128)
    parser.add_argument("--bounds", type=float, default=None,
                        help="half-extent of the fusion cube (default: from cameras)")
    parser.add_argument("--depth_trunc", type=float, default=None)
    parser.add_argument("--num_views", type=int, default=None)
    parser.add_argument("--max_tiles_per_gaussian", type=int, default=64)
    parser.add_argument("--max_instances", type=int, default=1 << 20)
    parser.add_argument("--tile_depth", type=int, default=1024)
    parser.add_argument("--export_images", action="store_true")
    args = get_combined_args(parser, argv)
    dev = resolve_device(device)
    # get_combined_args keeps only the flags that are not None, so the JAX
    # CLI raises AttributeError unless --bounds, --depth_trunc and
    # --num_views are all given; here an absent one takes its default
    bounds, depth_trunc, num_views = (getattr(args, k, None)
                                      for k in ("bounds", "depth_trunc", "num_views"))

    # the JAX CLI reads the PLY at the loader's default SH degree
    state, _ = load_iteration(args.model_path, args.iteration, 3, dev)
    scene = Scene(
        args.source_path,
        args.model_path,
        images=args.images,
        resolution=-1,
        eval_split=False,
        shuffle=False,
        device=dev,
    )
    cams = [lc.camera for lc in scene.train_cameras]
    if num_views:
        cams = cams[:: max(1, len(cams) // num_views)][:num_views]

    cfg = RasterConfig(
        max_tiles_per_gaussian=args.max_tiles_per_gaussian,
        max_instances=args.max_instances,
        tile_depth=args.tile_depth,
    )
    bg = torch.tensor([1.0, 1.0, 1.0] if args.white_background else [0.0, 0.0, 0.0],
                      device=dev)
    ex = GaussianExtractor(state, cfg, bg=bg)
    print(f"Rendering {len(cams)} views for fusion...")
    ex.reconstruction(cams)

    if bounds is not None:
        bmin = -np.ones(3) * bounds
        bmax = np.ones(3) * bounds
    else:
        centers = np.stack([c.camera_center.cpu().numpy() for c in cams])
        mid = centers.mean(0)
        r = float(np.linalg.norm(centers - mid, axis=1).max())
        bmin, bmax = mid - r, mid + r

    print(f"Fusing TSDF at {args.mesh_res}^3 over {bmin} .. {bmax}")
    mesh = ex.export_mesh(
        bmin, bmax, resolution=args.mesh_res, depth_trunc=depth_trunc,
        z_chunk=_z_chunk(dev, args.mesh_res),
    )
    out = os.path.join(args.model_path, "mesh", "fuse.ply")
    save_mesh_ply(mesh, out)
    print(f"wrote {out}: {len(mesh.vertices)} verts, {len(mesh.faces)} faces")
    if args.export_images:
        ex.export_image(os.path.join(args.model_path, "mesh"))
    return 0


def _z_chunk(dev, resolution: int) -> int:
    """The JAX package's 16 z-planes a chunk on the CPU; on the card about
    2^24 voxels a chunk (~1.5 GB of float64 temporaries), which leaves the
    grid unchanged (tsdf_fusion)."""
    if dev.type != "cuda":
        return 16
    return max(16, (1 << 24) // max(resolution * resolution, 1))


if __name__ == "__main__":
    main()
