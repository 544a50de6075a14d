"""Where a non-finite loss comes from in chip_smoke.py phase 8's training
run, on one CUDA card.

Phase 8 trains the port's CLI (`scripts/train.py`, tight culling) on a
COLMAP scene of eight 1088x1920 views of the bench cloud. The card's step
is not bit-reproducible (its atomics sum in any order), so runs of the same
code part after some steps, and one call stopped on a non-finite loss at
the CLI's iteration-100 check. This script writes phase 8's scene once,
then runs the CLI on it again and again for the first `--stop` iterations,
checking every step: the loss, every gradient and every parameter after
the update. At the first step with a non-finite value it prints which
values, keeps the step's inputs (the state before the step, the view and
its index) in `chiprun_out/phase8_nan_witness.pt`, and stops.

    python3 tests/phase8_nan_witness.py [--runs 20] [--stop 100]

Run from the repository root with one CUDA card visible (~12 s a run
after a ~10 s scene write).
"""
from __future__ import annotations

import argparse
import os
import shutil
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


class _NonFinite(Exception):
    pass


def main(argv=None) -> int:
    import torch

    import chip_smoke as cs
    from tpu_splat_torch.data.synthetic import orbit_camera
    from tpu_splat_torch.kernels import build
    from tpu_splat_torch.raster.config import production_config
    from tpu_splat_torch.scripts import train as cli
    from tpu_splat_torch.train import step as step_mod

    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=20)
    ap.add_argument("--stop", type=int, default=100)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("phase8_nan_witness: no CUDA device", file=sys.stderr)
        return 1
    build.build_all()
    dev = torch.device(cs.DEVICE)
    card = cs.card_line()
    root = os.path.join(cs.OUT_DIR, "phase8_nan_witness")
    shutil.rmtree(root, ignore_errors=True)
    scene_dir = os.path.join(root, "scene")
    state = cs.build_state(cs.N_GAUSS, cs.CAPACITY, device=dev)
    cams = [orbit_camera(cs.H, cs.W, radius=6.0, azimuth=a, elevation=0.3, device=dev)
            for a in cs.P8_AZIMUTHS]
    cs.write_colmap_scene(scene_dir, state, cams, production_config(**cs.PROD),
                          torch.zeros(3, device=dev))
    del state, cams
    print(f"[nan witness] card={card!r} scene written", flush=True)

    make = step_mod.make_train_step
    found = None

    def checked(*a, **k):
        step = make(*a, **k)

        def run(ts, camera, gt, bg, **sk):
            nonlocal found
            if ts.step >= args.stop:
                raise cs._StopRun(ts)
            new, aux = step(ts, camera, gt, bg, **sk)
            bad = [] if bool(torch.isfinite(aux.loss)) else ["loss"]
            bad += [f"grad:{n}" for n, g in aux.grads.items() if not bool(torch.isfinite(g).all())]
            bad += [f"param:{n}" for n, v in new.gaussians.param_pytree().items()
                    if not bool(torch.isfinite(v).all())]
            if bad:
                found = dict(iteration=ts.step + 1, bad=bad, frame_idx=sk.get("frame_idx"),
                             render_finite=bool(torch.isfinite(aux.render).all()),
                             n_alive=int(ts.gaussians.alive.sum()))
                # the alive rows (the file must stay small to come back);
                # features_rest is still zero this early, the ground truth
                # is the scene's image `frame_idx`
                alive = ts.gaussians.alive
                params = {n: (v[alive] if v.shape[0] == alive.shape[0] else v).detach().cpu()
                          for n, v in ts.gaussians.param_pytree().items()
                          if n != "features_rest"}
                if ts.isp is not None:
                    params.update({f"isp_{k}": v.detach().cpu()
                                   for k, v in ts.isp._asdict().items()})
                rest = float(ts.gaussians.param_pytree()["features_rest"].abs().max())
                torch.save(dict(found, params=params, features_rest_max=rest,
                                alive_rows=torch.nonzero(alive).flatten().cpu(),
                                world_view=camera.world_view.cpu(),
                                full_proj=camera.full_proj.cpu()),
                           os.path.join(cs.OUT_DIR, "phase8_nan_witness.pt"))
                raise _NonFinite(str(found))
            return new, aux

        return run

    step_mod.make_train_step = checked
    t0 = time.perf_counter()
    try:
        for r in range(args.runs):
            model_dir = os.path.join(root, f"model{r}")
            argv_r = ["-s", scene_dir, "-m", model_dir, *cs.P8_ARGS]
            try:
                cli.main(argv_r, device=str(dev))
            except cs._StopRun as stop:
                print(f"[nan witness] run {r}: {args.stop} steps finite, alive "
                      f"{int(stop.ts.gaussians.alive.sum())}, "
                      f"{time.perf_counter() - t0:.0f} s", flush=True)
            except _NonFinite as e:
                print(f"[nan witness] run {r}: NON-FINITE {e}", flush=True)
                break
            shutil.rmtree(model_dir, ignore_errors=True)
    finally:
        step_mod.make_train_step = make
        shutil.rmtree(root, ignore_errors=True)
    print(f"[nan witness] card={card!r} runs={r + 1} found={found}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
