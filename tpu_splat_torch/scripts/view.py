"""Serve a trained model to the SIBR remote viewer (port of
tpu_splat/scripts/view.py; role of reference view.py).

    python -m tpu_splat_torch.scripts.view -m <model_dir> [--ip 127.0.0.1] [--port 6009]

Loads a model dir (the PLY snapshot of --iteration, or a training
checkpoint's Gaussians via --start_checkpoint) and answers viewer requests
with render_fast frames in the requested render mode (view.py:53-78), one
tile_blend_forward launch a frame, until the server is closed.
"""
from __future__ import annotations


# the serving caps of the JAX package's view.py:55-60
VIEW_CAPS = dict(max_tiles_per_gaussian=64, max_instances=1 << 21, tile_depth=1024, chunk=32)


def main(argv=None, device: str = "cuda"):
    """The JAX CLI's flags; `device` is where the model renders (the tests
    pass "cpu"). Serves until `NetworkGUI.close()`."""
    import torch

    from tpu_splat_torch.config import build_parser, get_combined_args
    from tpu_splat_torch.core.device import resolve_device
    from tpu_splat_torch.raster.config import RasterConfig
    from tpu_splat_torch.scripts.render import load_model
    from tpu_splat_torch.viewer import network_gui

    parser = build_parser(fill_none_model=True)
    parser.add_argument("--ip", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=6009)
    parser.add_argument("--iteration", type=int, default=-1)
    parser.add_argument("--start_checkpoint", default=None)
    args = get_combined_args(parser, argv)
    dev = resolve_device(device)

    # the JAX view.py serves the Gaussians alone, without a checkpoint's ISP
    state, iteration, _ = load_model(args, dev, args.sh_degree, post_process=False)
    cfg = RasterConfig(**VIEW_CAPS)
    bg = torch.tensor([1.0, 1.0, 1.0] if getattr(args, "white_background", False)
                      else [0.0, 0.0, 0.0], device=dev)
    metrics = {"#": state.num_alive, "it": iteration}
    source = args.source_path or ""

    gui = network_gui.NetworkGUI(args.ip, args.port)
    print(f"View: {args.model_path} — serving on {args.ip}:{gui.listener.getsockname()[1]}")
    network_gui.serve(gui, state, cfg, bg, source, metrics)
    return 0


if __name__ == "__main__":
    main()
