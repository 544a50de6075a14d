"""Rendering-speed harness (port of tpu_splat/scripts/eval_fps.py; role of
reference eval_fps.py): mean FPS over N renders per test view + Gaussian
count -> fps.txt.

One warm-up render, then per view `--repeats` renders of `render_fast`
(`collect_weights=False`, the ISP's controller applied when a checkpoint
is given) and one `torch.cuda.synchronize()` inside the timed window, as
the JAX CLI ends each view with `jax.block_until_ready`.
"""
from __future__ import annotations

import os
import time

import numpy as np


def main(argv=None, device: str = "cuda"):
    """The JAX CLI's flags; `device` is where the model renders (the tests
    pass "cpu")."""
    import torch

    from tpu_splat_torch.config import build_parser, get_combined_args
    from tpu_splat_torch.core.device import resolve_device
    from tpu_splat_torch.data.scene import Scene
    from tpu_splat_torch.isp.ppisp import apply_isp
    from tpu_splat_torch.renderer import render_fast
    from tpu_splat_torch.scripts.render import add_capacity_flags, capacity_config, load_model

    parser = build_parser(fill_none_model=True)
    parser.add_argument("--iteration", type=int, default=-1)
    parser.add_argument("--start_checkpoint", type=str, default=None)
    parser.add_argument("--repeats", type=int, default=100)
    add_capacity_flags(parser)
    args = get_combined_args(parser, argv)
    dev = resolve_device(device)

    # the reference times renders WITH the ISP applied (eval_fps.py:17
    # imports ppisp and post-processes each frame)
    state, _, isp = load_model(args, dev, args.sh_degree, getattr(args, "post_process", True))
    n_gauss = state.num_alive

    scene = Scene(
        args.source_path, args.model_path, images=args.images,
        resolution=args.resolution, eval_split=True, shuffle=False, device=dev,
    )
    cams = scene.test_cameras or scene.train_cameras[:5]
    cfg = capacity_config(args)
    bg = torch.zeros(3, device=dev)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    def fwd(cam):
        img = render_fast(state, cam, cfg, bg, collect_weights=False).render
        return img if isp is None else apply_isp(isp, img, -1)

    fwd(cams[0].camera)  # warm-up
    sync()
    times = []
    for lc in cams:
        t0 = time.perf_counter()
        for _ in range(args.repeats):
            fwd(lc.camera)
        sync()
        times.append((time.perf_counter() - t0) / args.repeats)
    fps = 1.0 / np.mean(times)
    with open(os.path.join(args.model_path, "fps.txt"), "w") as f:
        f.write(f"{fps}\n{n_gauss}\n")
    print(f"FPS: {fps:.2f} over {len(cams)} views, {n_gauss} Gaussians")


if __name__ == "__main__":
    main()
