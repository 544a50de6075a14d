"""Trajectory video rendering (port of tpu_splat/scripts/video.py; role of
reference video.py / render-videos.py).

Generates an ellipse path fitted to the training cameras, renders frames
with render_fast, writes PNG frames (and an MP4 when imageio/ffmpeg is
available)."""
from __future__ import annotations

import os

import numpy as np


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
    from tpu_splat_torch.renderer import render_fast
    from tpu_splat_torch.scripts.render import add_capacity_flags, capacity_config, load_iteration

    parser = build_parser(fill_none_model=True)
    parser.add_argument("--iteration", type=int, default=-1)
    add_capacity_flags(parser)
    parser.add_argument("--n_frames", type=int, default=120)
    parser.add_argument("--fps", type=int, default=30)
    args = get_combined_args(parser, argv)
    dev = resolve_device(device)

    state, it = load_iteration(args.model_path, args.iteration, args.sh_degree, dev)
    scene = Scene(
        args.source_path, args.model_path, images=args.images,
        resolution=args.resolution, eval_split=False, shuffle=False, device=dev,
    )
    # PCA-canonical ellipse path warped back to world coordinates
    # (reference generate_path, render_utils.py:176-208)
    cams = generate_path(scene.train_cameras, n_frames=args.n_frames)

    cfg = capacity_config(args)
    bg = torch.zeros(3, device=dev)
    out_dir = os.path.join(args.model_path, "traj", f"ours_{it}")
    frames = []
    for i, cam in enumerate(cams):
        img = render_fast(state, cam, cfg, bg).render.cpu().numpy()
        save_image_u8(os.path.join(out_dir, f"{i:05d}.png"), img)
        # the JAX CLI's frame quantisation: truncation, no +0.5
        frames.append((np.clip(img, 0, 1) * 255).astype(np.uint8))
    print(f"wrote {len(frames)} frames to {out_dir}")

    try:
        import imageio.v2 as imageio

        mp4 = os.path.join(args.model_path, f"traj_{it}.mp4")
        imageio.mimwrite(mp4, frames, fps=args.fps)
        print(f"wrote {mp4}")
    except Exception as e:  # imageio/ffmpeg optional, as in the JAX CLI
        print(f"(video muxing unavailable: {e}; PNG frames saved)")


if __name__ == "__main__":
    main()
