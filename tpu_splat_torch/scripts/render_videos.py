"""Trajectory color+depth video rendering (port of
tpu_splat/scripts/render_videos.py; role of reference render-videos.py:
generate_path over the training cameras, render every frame with the full
`render` (surface depth on the card), export image sequences and mux videos).

    python -m tpu_splat_torch.scripts.render_videos -m <model_dir> --render_path
"""
from __future__ import annotations

import os

import numpy as np


def _turbo_depth(depth: np.ndarray, alpha: np.ndarray) -> np.ndarray:
    """Normalized depth visualization [H,W] -> [H,W,3]."""
    d = np.where(alpha > 0.5, depth, np.nan)
    lo = np.nanpercentile(d, 2) if np.isfinite(d).any() else 0.0
    hi = np.nanpercentile(d, 98) if np.isfinite(d).any() else 1.0
    x = np.clip((depth - lo) / max(hi - lo, 1e-6), 0, 1)
    r = np.clip(1.5 - np.abs(2.0 * x - 1.0) * 2.0, 0, 1)
    g = np.clip(1.5 - np.abs(2.0 * x - 0.5) * 2.0, 0, 1)
    b = np.clip(1.5 - np.abs(2.0 * x) * 2.0, 0, 1)
    return np.stack([x * 0 + r, g, b], axis=-1) * (alpha > 0.05)[..., None]


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
    from tpu_splat_torch.eval.image_utils import save_image_u8
    from tpu_splat_torch.eval.trajectories import generate_path
    from tpu_splat_torch.renderer import render
    from tpu_splat_torch.scripts.render import add_capacity_flags, capacity_config, load_iteration

    parser = build_parser(fill_none_model=True)
    parser.add_argument("--iteration", type=int, default=-1)
    add_capacity_flags(parser)
    parser.add_argument("--render_path", action="store_true")
    parser.add_argument("--n_frames", type=int, default=480)
    parser.add_argument("--fps", type=int, default=30)
    args = get_combined_args(parser, argv)
    dev = resolve_device(device)

    state, it = load_iteration(args.model_path, args.iteration, args.sh_degree, dev)
    scene = Scene(
        args.source_path, args.model_path, images=args.images,
        resolution=args.resolution, eval_split=False, shuffle=False, device=dev,
    )
    if not args.render_path:
        print("nothing to do (pass --render_path)")
        return

    cams = generate_path(scene.train_cameras, n_frames=args.n_frames)
    cfg = capacity_config(args)
    bg = torch.zeros(3, device=dev)
    traj_dir = os.path.join(args.model_path, "traj", f"ours_{it}")
    rgb_frames, depth_frames = [], []
    for i, cam in enumerate(cams):
        # no autograd graph: a frame's would otherwise live until the next
        with torch.inference_mode():
            out = render(state, cam, cfg, bg, initial_stage=False)
        img = out.render.cpu().numpy()
        dep = _turbo_depth(out.surf_depth.cpu().numpy()[..., 0], out.alpha.cpu().numpy()[..., 0])
        save_image_u8(os.path.join(traj_dir, "renders", f"{i:05d}.png"), img)
        save_image_u8(os.path.join(traj_dir, "depth", f"{i:05d}.png"), dep)
        rgb_frames.append((np.clip(img, 0, 1) * 255).astype(np.uint8))
        depth_frames.append((np.clip(dep, 0, 1) * 255).astype(np.uint8))
    print(f"rendered {len(cams)} trajectory frames to {traj_dir}")

    try:
        import imageio.v2 as imageio

        for name, frames in (("color", rgb_frames), ("depth", depth_frames)):
            mp4 = os.path.join(args.model_path, f"traj_{name}_{it}.mp4")
            imageio.mimwrite(mp4, frames, fps=args.fps)
            print(f"wrote {mp4}")
    except Exception as e:  # imageio/ffmpeg optional, as in the JAX CLI
        print(f"(video muxing unavailable: {e}; PNG frames saved)")


if __name__ == "__main__":
    main()
