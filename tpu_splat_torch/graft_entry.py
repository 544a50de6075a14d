"""Entry points for a quick check of the port (counterpart of the
repository's `__graft_entry__.py`).

entry() -> (fn, example_args): the forward render of the flagship model
(deferred-reflection surfel splatting) on a tiny scene.

dryrun_multichip(n) runs one tile-sharded training step
(`make_train_step(mesh=...)`) and one camera-DP step
(`make_train_step_dp`) of the tiny scene over n ranks, under the
production switches.

    python -m tpu_splat_torch.graft_entry   # on the card: entry, then every local card
"""
from __future__ import annotations

import numpy as np
import torch


def _tiny_scene(device="cuda", n=384, capacity=512, H=128, W=128, cubemap=16, seed=0):
    """Big enough that every rank of an 8-way tile mesh owns several
    non-empty tiles with multi-chunk ranges, small enough for the CPU."""
    from tpu_splat_torch.data.synthetic import orbit_camera
    from tpu_splat_torch.model.state import init_from_pcd
    from tpu_splat_torch.raster.config import production_config

    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    state = init_from_pcd(pts, cols, capacity=capacity, cubemap_resolution=cubemap,
                          device=device)
    cam = orbit_camera(H, W, radius=4.0, azimuth=0.4, elevation=0.3, device=device)
    cfg = production_config(max_tiles_per_gaussian=32, max_instances=32768, tile_depth=512,
                            chunk=16)
    return state, cam, cfg


def entry(device="cuda"):
    from tpu_splat_torch.renderer import render

    state, cam, cfg = _tiny_scene(device)
    bg = torch.zeros(3, device=state.device)

    def forward(gaussians):
        return render(gaussians, cam, cfg, bg, initial_stage=False).render

    return forward, (state,)


def _dryrun_rank(rank: int, n: int, device: str) -> dict:
    from tpu_splat_torch.config import OptimizationParams
    from tpu_splat_torch.data.synthetic import orbit_camera
    from tpu_splat_torch.dist import make_mesh
    from tpu_splat_torch.train.step import TrainState, make_train_step, make_train_step_dp

    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    state, cam, cfg = _tiny_scene(dev)
    opt_cfg = OptimizationParams()
    ts = TrainState.create(state, opt_cfg)
    bg = torch.zeros(3, device=dev)
    gt = torch.full((cam.height, cam.width, 3), 0.5, device=dev)
    out = {}
    step = make_train_step(opt_cfg, cfg, spatial_lr_scale=1.0, mesh=make_mesh(n, "tiles"))
    _, aux = step(ts, cam, gt, bg)
    out["tiles"] = dict(loss=float(aux.loss), psnr=float(aux.psnr),
                        instances=int(aux.num_instances))
    # camera-batch data parallelism: n cameras a step, one per rank
    cams = [orbit_camera(cam.height, cam.width, radius=4.0, azimuth=0.3 * i, elevation=0.3,
                         device=dev) for i in range(n)]
    dp = make_train_step_dp(opt_cfg, cfg, spatial_lr_scale=1.0, mesh=make_mesh(n, "dp"))
    _, aux = dp(ts, cams, [gt] * n, bg)
    out["dp"] = dict(loss=float(aux.loss), psnr=float(aux.psnr),
                     instances=int(aux.num_instances))
    for mode, r in out.items():
        if not np.isfinite(r["loss"]):
            raise AssertionError(f"dryrun_multichip({n}): non-finite {mode} loss {r['loss']}")
    return out


def dryrun_multichip(n_devices: int, device: str = "cuda") -> dict:
    """One tile-sharded and one camera-DP step over `n_devices` ranks
    started here: over NCCL, one card a rank, when there are that many
    cards, else over gloo (several ranks then share a card); on the CPU
    over gloo. -> rank 0's losses, PSNRs and instance counts."""
    from tpu_splat_torch.core.device import resolve_device
    from tpu_splat_torch.dist import launch

    on_card = resolve_device(device).type == "cuda"
    backend = "nccl" if on_card and n_devices <= torch.cuda.device_count() else "gloo"
    out = launch(_dryrun_rank, n_devices, args=(n_devices, device), backend=backend)[0]
    for mode in ("tiles", "dp"):
        r = out[mode]
        print(f"dryrun_multichip({n_devices}): {mode} loss={r['loss']:.4f} "
              f"psnr={r['psnr']:.2f} instances={r['instances']}")
    return out


if __name__ == "__main__":
    fn, args = entry()
    img = fn(*args)
    print("entry forward:", tuple(img.shape), img.dtype)
    dryrun_multichip(min(8, torch.cuda.device_count()))
