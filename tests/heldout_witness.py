"""Held-out witness for chip_smoke.py's phase 8, on the CPU.

Phase 8 trains the port's CLI on eight views of the bench cloud and
records the held-out view's PSNR. This script asks whether that curve is a
property of the scene and the schedule or of the port: it builds the same
scene at 1/scale of its size (the cloud's count over scale^2, its surfels
scale times larger, so each pixel sees what a full-size pixel sees; the
views at H/scale x W/scale; the points over scale^2), trains it with both
packages' CLI under phase 8's flags (the instance capacity over scale^2),
the port handed the JAX run's draws (tests/test_torch_cli_schedule.py),
and prints both packages' test and train PSNR every 25 iterations.

    python -m tests.heldout_witness [--scale 8] [--stop 300] [--json PATH]

Run from the repository root; it takes tens of minutes (the JAX side runs
its Pallas kernels in interpret mode).
"""
from __future__ import annotations

import argparse
import json
import math
import os
import tempfile

os.environ.setdefault("JAX_PLATFORMS", "cpu")


def main(argv=None):
    import jax

    jax.config.update("jax_platforms", "cpu")
    import torch

    import chip_smoke as cs
    from tests.test_torch_cli_schedule import run_both
    from tpu_splat_torch.data.synthetic import orbit_camera
    from tpu_splat_torch.raster.config import production_config

    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=int, default=8)
    ap.add_argument("--stop", type=int, default=cs.P8_STOP)
    ap.add_argument("--json", default=None)
    a = ap.parse_args(argv)
    s2 = a.scale * a.scale
    h, w = cs.H // a.scale, cs.W // a.scale
    n, points = cs.N_GAUSS // s2, cs.P8_POINTS // s2
    max_instances = -(-cs.PROD["max_instances"] // s2 // 4096) * 4096
    state = cs.build_state(n, n, scale_mu=-4.8 + math.log(a.scale), device="cpu")
    cams = [orbit_camera(h, w, radius=6.0, azimuth=az, elevation=0.3, device="cpu")
            for az in cs.P8_AZIMUTHS]
    args = list(cs.P8_ARGS)
    args[args.index("--max_instances") + 1] = str(max_instances)
    args[args.index("--test_iterations") + 1:args.index("--save_iterations")] = [
        str(i) for i in [1, *range(25, a.stop + 1, 25)]]
    with tempfile.TemporaryDirectory() as root:
        src = os.path.join(root, "scene")
        cs.write_colmap_scene(src, state, cams,
                              production_config(**dict(cs.PROD, max_instances=max_instances)),
                              torch.zeros(3), points=points)
        run_both(src, root, args, a.stop)
        curves = {}
        for pkg in ("jax", "port"):
            with open(os.path.join(root, pkg, "training_report.jsonl")) as f:
                curves[pkg] = [json.loads(line) for line in f]
    print(f"scene 1/{a.scale}: {h}x{w}, {n} surfels, {points} points, "
          f"max_instances {max_instances}")
    print("iteration  test PSNR jax / port  train PSNR jax / port")
    for rj, rp in zip(curves["jax"], curves["port"]):
        print(f"{rj['iteration']:9d}  {rj['test']['psnr']:8.4f} / {rp['test']['psnr']:8.4f}  "
              f"{rj['train']['psnr']:8.4f} / {rp['train']['psnr']:8.4f}")
    out = dict(scale=a.scale, height=h, width=w, surfels=n, points=points,
               max_instances=max_instances, args=args, curves=curves)
    if a.json:
        with open(a.json, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps({k: out[k] for k in ("scale", "height", "width", "surfels", "points")}))


if __name__ == "__main__":
    main()
