"""Normal mean-angular-error eval (port of tpu_splat/scripts/eval_mae.py;
role of reference eval_mae.py + utils/mae_utils.py): renders normal maps
for test views, compares against GT normal images with alpha masking ->
mae.txt (degrees)."""
from __future__ import annotations

import os

import numpy as np


def mae_degrees(pred: np.ndarray, gt: np.ndarray, mask: np.ndarray | None = None):
    """Mean angular error in degrees between normal maps in [-1,1]^3."""
    pn = pred / (np.linalg.norm(pred, axis=-1, keepdims=True) + 1e-8)
    gn = gt / (np.linalg.norm(gt, axis=-1, keepdims=True) + 1e-8)
    cos = np.clip(np.sum(pn * gn, axis=-1), -1.0, 1.0)
    ang = np.degrees(np.arccos(cos))
    if mask is not None:
        m = mask > 0.5
        return float(ang[m].mean()) if m.any() else float("nan")
    return float(ang.mean())


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
    from tpu_splat_torch.eval.image_utils import read_images_rgb
    from tpu_splat_torch.renderer import render_fast
    from tpu_splat_torch.scripts.render import add_capacity_flags, capacity_config, load_iteration

    parser = build_parser(fill_none_model=True)
    parser.add_argument("--iteration", type=int, default=-1)
    add_capacity_flags(parser)
    parser.add_argument("--gt_normals_dir", type=str, default=None,
                        help="dir of GT normal images (default <src>/normals)")
    args = get_combined_args(parser, argv)
    dev = resolve_device(device)

    state, it = load_iteration(args.model_path, args.iteration, args.sh_degree, dev)
    scene = Scene(
        args.source_path, args.model_path, images=args.images,
        resolution=args.resolution, eval_split=True, shuffle=False, device=dev,
    )
    gt_dir = args.gt_normals_dir or os.path.join(args.source_path, "normals")
    cfg = capacity_config(args)
    bg = torch.zeros(3, device=dev)

    maes = []
    for lc in scene.test_cameras:
        gt_path = os.path.join(gt_dir, lc.image_name + ".png")
        if not os.path.exists(gt_path):
            continue
        out = render_fast(state, lc.camera, cfg, bg)
        pred = out.normal.cpu().numpy()
        alpha = out.alpha.cpu().numpy()[..., 0]
        (gt,) = read_images_rgb([gt_path])
        maes.append(mae_degrees(pred, gt / 255.0 * 2.0 - 1.0, alpha))
    if maes:
        mae = float(np.mean(maes))
        with open(os.path.join(args.model_path, "mae.txt"), "w") as f:
            f.write(f"{mae}\n")
        print(f"MAE: {mae:.3f} deg over {len(maes)} views")
    else:
        print("No GT normal maps found; skipping")


if __name__ == "__main__":
    main()
