"""Viewer smoke test (port of tpu_splat/scripts/test_rasterizer.py; role of
reference test-rasterizer.py + StageScene): serve a 5-Gaussian stage scene
over the SIBR viewer protocol, or render one frame headless with
--headless.

    python -m tpu_splat_torch.scripts.test_rasterizer --headless
"""
from __future__ import annotations

from argparse import ArgumentParser

import numpy as np

STAGE_CAPS = dict(max_tiles_per_gaussian=16, max_instances=4096, tile_depth=128, chunk=16)


def stage_state(capacity: int = 8, device="cuda"):
    """5 random Gaussians near the origin (reference StageScene,
    scene/__init__.py:26-42), from the JAX package's numpy draws."""
    from tpu_splat_torch.model.state import init_from_pcd

    rng = np.random.default_rng(0)
    pts = rng.normal(scale=0.5, size=(5, 3)).astype(np.float32)
    cols = rng.uniform(0.2, 1.0, (5, 3)).astype(np.float32)
    return init_from_pcd(pts, cols, capacity=capacity, cubemap_resolution=8, device=device)


def main(argv=None, device: str = "cuda"):
    import torch

    from tpu_splat_torch.core.device import resolve_device
    from tpu_splat_torch.raster.config import RasterConfig

    parser = ArgumentParser()
    parser.add_argument("--headless", action="store_true")
    parser.add_argument("--ip", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=6009)
    args = parser.parse_args(argv)
    dev = resolve_device(device)

    state = stage_state(device=dev)
    cfg = RasterConfig(**STAGE_CAPS)
    bg = torch.zeros(3, device=dev)

    if args.headless:
        from tpu_splat_torch.data.synthetic import orbit_camera
        from tpu_splat_torch.renderer import render_fast

        cam = orbit_camera(128, 128, radius=4.0, device=dev)
        out = render_fast(state, cam, cfg, bg)
        img = out.render
        print(
            f"stage render: {tuple(img.shape)}, coverage "
            f"{float((out.alpha > 0.1).float().mean()):.3f}, "
            f"nan={bool(torch.isnan(img).any())}"
        )
        return

    from tpu_splat_torch.viewer import network_gui

    gui = network_gui.NetworkGUI(args.ip, args.port)
    print(f"serving stage scene on {args.ip}:{gui.listener.getsockname()[1]}")
    network_gui.serve(gui, state, cfg, bg, "stage", {"num_gaussians": 5})


if __name__ == "__main__":
    main()
