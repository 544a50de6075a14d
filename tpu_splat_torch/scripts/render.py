"""Offline rendering CLI (port of tpu_splat/scripts/render.py; role of
reference render.py).

    python -m tpu_splat_torch.scripts.render -m <model_dir> [-s <scene>] [--skip_train]

Loads a trained snapshot (the PLY of an iteration, or a checkpoint with its
ISP), renders the train and test sets with render_fast on the card, and
writes renders/ + gt/ under <model>/{train,test}/ours_<iter>/ (the layout
metrics.py consumes) and two lat-long env-map previews. PNGs are written
with the numpy writer; pixels are rounded on the host as the JAX package
rounds them.
"""
from __future__ import annotations

import os



def find_max_iteration(model_path: str) -> int:
    """reference utils/system_utils.py:26-28 searchForMaxIteration. As in
    the JAX package, every `iteration_*` entry must end in a number: the
    `iteration_<it>_visible` directory of visible_gaussians.py makes it
    raise ValueError (pass --iteration then)."""
    root = os.path.join(model_path, "point_cloud")
    iters = [
        int(d.split("_")[-1]) for d in os.listdir(root) if d.startswith("iteration_")
    ]
    return max(iters)


def add_capacity_flags(parser):
    """The renderer's capacity flags, with the train CLI's names and
    defaults (RasterConfig()'s values). A train CLI's cfg_args holds them,
    and its values win over the command line (get_combined_args)."""
    parser.add_argument("--max_tiles_per_gaussian", type=int, default=64)
    parser.add_argument("--max_instances", type=int, default=1 << 20)
    parser.add_argument("--tile_depth", type=int, default=1024)


def capacity_config(args, **switches):
    """RasterConfig of the capacity flags (add_capacity_flags)."""
    from tpu_splat_torch.raster.config import RasterConfig

    return RasterConfig(max_tiles_per_gaussian=args.max_tiles_per_gaussian,
                        max_instances=args.max_instances, tile_depth=args.tile_depth,
                        **switches)


def load_iteration(model_path: str, iteration: int, sh_degree, dev):
    """-> (GaussianState, iteration): the PLY snapshot of `iteration`, or
    of the newest one when it is not positive."""
    from tpu_splat_torch.model.io import load_ply

    it = iteration if iteration > 0 else find_max_iteration(model_path)
    ply = os.path.join(model_path, "point_cloud", f"iteration_{it}", "point_cloud.ply")
    return load_ply(ply, max_sh_degree=sh_degree, device=dev), it


def load_model(args, dev, sh_degree, post_process: bool):
    """-> (GaussianState, iteration, ISP or None): the checkpoint of
    --start_checkpoint (with its trained ISP when `post_process`), else
    the PLY of --iteration."""
    from tpu_splat_torch.model.io import load_checkpoint_gaussians, load_checkpoint_isp

    if not getattr(args, "start_checkpoint", None):
        state, it = load_iteration(args.model_path, args.iteration, sh_degree, dev)
        print(f"Loaded {state.num_alive} Gaussians of iteration {it}")
        return state, it, None
    state, it = load_checkpoint_gaussians(args.start_checkpoint, device=dev)
    print(f"Loaded checkpoint {args.start_checkpoint} (iteration {it})")
    isp = load_checkpoint_isp(args.start_checkpoint, device=dev) if post_process else None
    if isp is not None:
        print("Applying trained ISP to renders (post_process)")
    return state, it, isp


def render_sets(args, device: str = "cuda"):
    import torch

    from tpu_splat_torch.config import ModelParams, PipelineParams
    from tpu_splat_torch.core.device import resolve_device
    from tpu_splat_torch.data.scene import Scene
    from tpu_splat_torch.eval.image_utils import save_image_u8
    from tpu_splat_torch.isp.ppisp import apply_isp
    from tpu_splat_torch.renderer import render_env_map, render_fast

    dev = resolve_device(device)
    model = ModelParams.extract(args).finalize()
    pipe = PipelineParams.extract(args)
    state, it, isp = load_model(args, dev, model.sh_degree, model.post_process)
    scene = Scene(
        model.source_path,
        model.model_path,
        images=model.images,
        resolution=model.resolution,
        eval_split=model.eval,
        shuffle=False,
        device=dev,
    )
    cfg = capacity_config(args, depth_ratio=pipe.depth_ratio)
    bg = torch.tensor([1.0, 1.0, 1.0] if model.white_background else [0.0, 0.0, 0.0],
                      device=dev)
    host = lambda t: t.cpu().numpy()

    for k, v in render_env_map(state).items():
        save_image_u8(os.path.join(model.model_path, f"{k}.png"), host(v))

    sets = []
    if not args.skip_train:
        sets.append(("train", scene.train_cameras))
    if not args.skip_test:
        sets.append(("test", scene.test_cameras))
    for name, cams in sets:
        base = os.path.join(model.model_path, name, f"ours_{it}")
        for idx, lc in enumerate(cams):
            out = render_fast(state, lc.camera, cfg, bg)
            img = out.render
            if isp is not None:
                # train views keep their per-frame transform; test views use
                # the shared controller (reference render.py:58-59:
                # frame_idx=-1 for unknown frames)
                img = apply_isp(isp, img, frame_idx=lc.frame_idx if name == "train" else -1)
            save_image_u8(os.path.join(base, "renders", f"{idx:05d}.png"), host(img))
            save_image_u8(os.path.join(base, "gt", f"{idx:05d}.png"), host(lc.image))
            if args.save_normals:
                save_image_u8(os.path.join(base, "normals", f"{idx:05d}.png"),
                              host(out.normal) * 0.5 + 0.5)
            if args.save_refl:
                save_image_u8(os.path.join(base, "refl", f"{idx:05d}.png"),
                              host(out.refl_strength).repeat(3, -1))
        print(f"{name}: rendered {len(cams)} views to {base}")


def main(argv=None, device: str = "cuda"):
    """The JAX CLI's flags; `device` is where the model renders (the tests
    pass "cpu")."""
    from tpu_splat_torch.config import build_parser, get_combined_args

    parser = build_parser(fill_none_model=True)
    parser.add_argument("--iteration", type=int, default=-1)
    parser.add_argument("--start_checkpoint", type=str, default=None)
    parser.add_argument("--skip_train", action="store_true")
    parser.add_argument("--skip_test", action="store_true")
    parser.add_argument("--save_normals", action="store_true")
    parser.add_argument("--save_refl", action="store_true")
    add_capacity_flags(parser)
    args = get_combined_args(parser, argv)
    render_sets(args, device=device)


if __name__ == "__main__":
    main()
