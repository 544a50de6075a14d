"""Prune Gaussians invisible from every training view (port of
tpu_splat/scripts/visible_gaussians.py; role of reference
visible-gaussians.py): renders all views, keeps those with max blend weight
> 0 anywhere, saves the pruned model to iteration_<it>_visible/ +
visible.txt."""
from __future__ import annotations

import dataclasses
import os


def main(argv=None, device: str = "cuda"):
    """The JAX CLI's flags; `device` is where the model renders (the tests
    pass "cpu"). Unlike the JAX CLI, which renders at `RasterConfig()`,
    it takes render.py's capacity flags (the same defaults): at 1088x1920 a
    trained model can need more than RasterConfig()'s 1<<20 instances, and
    the renderer drops the rest silently."""
    import torch

    from tpu_splat_torch.config import build_parser, get_combined_args
    from tpu_splat_torch.core.device import resolve_device
    from tpu_splat_torch.data.scene import Scene
    from tpu_splat_torch.model.io import save_ply
    from tpu_splat_torch.renderer import render_fast
    from tpu_splat_torch.scripts.render import add_capacity_flags, capacity_config, load_iteration

    parser = build_parser(fill_none_model=True)
    parser.add_argument("--iteration", type=int, default=-1)
    add_capacity_flags(parser)
    args = get_combined_args(parser, argv)
    dev = resolve_device(device)

    state, it = load_iteration(args.model_path, args.iteration, args.sh_degree, dev)
    scene = Scene(
        args.source_path, args.model_path, images=args.images,
        resolution=args.resolution, eval_split=False, shuffle=False, device=dev,
    )
    cfg = capacity_config(args)
    bg = torch.zeros(3, device=dev)

    seen = torch.zeros(state.capacity, dtype=torch.bool, device=dev)
    for lc in scene.train_cameras:
        out = render_fast(state, lc.camera, cfg, bg)
        seen |= out.gaussian_weights > 0.0
    total = state.num_alive
    visible = int((seen & state.alive).sum())
    print(f"visible: {visible}/{total}")

    pruned = dataclasses.replace(state, alive=state.alive & seen)
    out_dir = os.path.join(args.model_path, "point_cloud", f"iteration_{it}_visible")
    save_ply(pruned, os.path.join(out_dir, "point_cloud.ply"))
    with open(os.path.join(args.model_path, "visible.txt"), "w") as f:
        f.write(f"{visible}\n{total}\n")


if __name__ == "__main__":
    main()
