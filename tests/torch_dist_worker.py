"""Rank-side work of tests/test_torch_dist.py and tests/test_torch_dist_dp.py.

Each rank is a fresh process that `tpu_splat_torch.dist.launch` starts and
joins over gloo on the CPU. This module imports torch and the port only,
never JAX: the JAX references are computed in the test process, and only
their inputs come here, as numpy arrays. Every rank returns its results as
numpy arrays, so the test holds each rank's against the references and the
ranks against each other.
"""
import numpy as np
import torch

from tpu_splat_torch.config import OptimizationParams
from tpu_splat_torch.dist import make_mesh
from tpu_splat_torch.isp.ppisp import ISPConfig
from tpu_splat_torch.model.convert import camera_from_numpy, train_state_from_numpy
from tpu_splat_torch.raster import rasterize
from tpu_splat_torch.raster.binning import bin_gaussians
from tpu_splat_torch.raster.blend import blend_kernel_path
from tpu_splat_torch.raster.config import RasterConfig, production_config
from tpu_splat_torch.raster.preprocess import preprocess
from tpu_splat_torch.train.loop import EventLog, run_scheduled_events
from tpu_splat_torch.train.step import make_train_step, make_train_step_dp


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: _host(v) for k, v in x.items()}
    return x


def _raster(g, cam, bg, cfg, mesh):
    return rasterize(g.xyz, g.get_scaling(), g.rotation, g.get_opacity(), g.get_refl(), cam,
                     bg, cfg, sh=g.get_features(), sh_degree=g.max_sh_degree, alive=g.alive,
                     mesh=mesh)


def _blend_only(g, cam, bg, cfg, mesh):
    """preprocess, binning padded to the mesh, `blend_kernel_path(mesh=...)`."""
    H, W = cam.height, cam.width
    prep = preprocess(g.xyz, g.get_scaling(), g.rotation, cam.world_view, cam.full_proj,
                      cam.camera_center, H, W, sh=g.get_features(), sh_degree=g.max_sh_degree)
    valid = prep.valid & g.alive
    prep = prep._replace(valid=valid, tiles_touched=torch.where(valid, prep.tiles_touched, 0))
    binned = bin_gaussians(prep, H, W, cfg, pad_tiles_to=1 if mesh is None else mesh.size)
    return blend_kernel_path(binned, prep.hom, prep.xy, g.get_opacity(), prep.normal_view,
                             prep.color, g.get_refl(), torch.ones_like(valid), bg, H, W,
                             train_shape=cfg.grad_channels == "train",
                             bf16_grads=cfg.bf16_grads, bf16_feats=cfg.bf16_feats, mesh=mesh)


def _step_kwargs(inp):
    return dict(use_env_scope=True, env_scope_center=inp["scope_center"],
                env_scope_radius=inp["scope_radius"], isp_cfg=ISPConfig(**inp["isp_cfg"]))


def _state_out(ts, aux):
    return dict(
        loss={f: float(getattr(aux, f)) for f in ("loss", "l1", "ssim", "normal_loss")},
        diag={f: int(getattr(aux, f)) for f in ("num_instances", "max_tile_count",
                                                "pad_overflow")},
        params=_host({**ts.gaussians.param_pytree(),
                      **{f"isp_{k}": v for k, v in ts.isp._asdict().items()}}),
        mu=_host(ts.opt.mu), nu=_host(ts.opt.nu),
        stats=_host(ts.stats._asdict()),
    )


def _one_core():
    """The test process compiles the JAX references while the ranks run:
    each rank takes one core, so the ranks of both mesh sizes and the
    compiler do not oversubscribe the host."""
    torch.set_num_threads(1)


def tiles_cases(rank: int, n: int, inp: dict) -> dict:
    """The tile-sharded render, the tile-sharded training step (ISP and
    env scope on) and the scan blend with and without the mesh."""
    _one_core()
    mesh = make_mesh(n, "tiles")
    bg = torch.tensor(inp["bg"])
    ts = train_state_from_numpy(inp["ts"], device="cpu")
    out = {}

    cam = camera_from_numpy(inp["cam_render"], "cpu")
    for name, m in (("render", mesh), ("render_single", None)):
        o = _raster(ts.gaussians, cam, bg,
                    production_config(grad_channels="full", **inp["kw"]), m)
        out[name] = _host(dict(color=o.color, alpha=o.others[..., 1], n_contrib=o.n_contrib,
                               gw=o.gaussian_weights, num_instances=o.num_instances,
                               max_tile=o.tile_counts.max(), pad_overflow=o.pad_overflow))

    step = make_train_step(OptimizationParams(),
                           production_config(bf16_grads=False, bf16_feats=False, **inp["kw"]),
                           1.0, mesh=mesh, **_step_kwargs(inp))
    new, aux = step(ts, camera_from_numpy(inp["cam_step"], "cpu"), torch.tensor(inp["gt"]), bg,
                    frame_idx=inp["frame"])
    out["step"] = dict(_state_out(new, aux), grads=_host(aux.grads), render=_host(aux.render))

    # the kernel path's blend-only mesh branch (replicated slab, the tile
    # axis split over the ranks), sharded against unsharded
    cfg = production_config(**inp["kw"])
    for name, m in (("blend_sharded", mesh), ("blend_single", None)):
        p = {k: v.detach().requires_grad_(True) for k, v in ts.gaussians.param_pytree().items()}
        o = _blend_only(ts.gaussians.with_params(p), cam, bg, cfg, m)
        loss = torch.mean((o.color - 0.3) ** 2) + 0.1 * torch.mean(o.others[..., 2:5] ** 2)
        g = torch.autograd.grad(loss, list(p.values()), allow_unused=True)
        out[name] = _host(dict(color=o.color, others=o.others, gw=o.gaussian_weights,
                               grads={k: torch.zeros_like(p[k]) if x is None else x
                                      for k, x in zip(p, g)}))

    # the scan blend: sharded against unsharded, both here
    scan_cfg = RasterConfig(backend="xla", **inp["kw"])
    for name, m in (("scan_sharded", mesh), ("scan_single", None)):
        p = {k: v.detach().requires_grad_(True) for k, v in ts.gaussians.param_pytree().items()}
        o = _raster(ts.gaussians.with_params(p), cam, bg, scan_cfg, m)
        loss = torch.mean((o.color - 0.3) ** 2) + 0.1 * torch.mean(o.others[..., 6])
        g = torch.autograd.grad(loss, list(p.values()), allow_unused=True)
        out[name] = _host(dict(color=o.color, others=o.others, n_contrib=o.n_contrib,
                               gw=o.gaussian_weights,
                               grads={k: torch.zeros_like(p[k]) if x is None else x
                                      for k, x in zip(p, g)}))
    return out


def dp_cases(rank: int, n: int, inp: dict) -> dict:
    """One camera-DP step per case (cameras, images, frame indices and loss
    masks or None; the same batch on every rank), then the scheduled events
    of the densify iteration `inp["densify_at"]` on the new state."""
    _one_core()
    mesh = make_mesh(n, "dp")
    bg = torch.tensor(inp["bg"])
    opt = OptimizationParams()
    out = {}
    for name, case in inp["cases"].items():
        ts = train_state_from_numpy(case["ts"], device="cpu")
        step = make_train_step_dp(opt, production_config(**inp["cfg"]), 1.0, mesh,
                                  **_step_kwargs(inp))
        masks = None if case["masks"] is None else [torch.tensor(m) for m in case["masks"]]
        new, aux = step(ts, [camera_from_numpy(c, "cpu") for c in case["cams"]],
                        [torch.tensor(g) for g in case["gts"]], bg,
                        frame_idx=case["frames"], pix_masks=masks)
        out[name] = _state_out(new, aux)
        log = EventLog()
        ev = run_scheduled_events(new, inp["densify_at"], opt, cameras_extent=1.0,
                                  cameras_mean=np.zeros(3, np.float32), log=log)
        out[name]["densified"] = dict(
            params=_host(ev.gaussians.param_pytree()), alive=_host(ev.gaussians.alive),
            counts=(log.densified, log.pruned))
    return out


def card_sharded_step(rank: int, n: int, device: str = "cuda") -> dict:
    """On the card (each rank on its current one): the tile-sharded
    production step (ISP and env scope on, deferred stage) of a 3000-surfel
    scene at 192x256 against the unsharded step from the same state. ->
    the largest differences, this rank's launches of the sharded step, and
    a hash of the parameters after it."""
    import hashlib

    from tpu_splat_torch.data.synthetic import orbit_camera, random_scene
    from tpu_splat_torch.kernels import LAUNCHES
    from tpu_splat_torch.model.convert import state_from_numpy
    from tpu_splat_torch.train.step import TrainState

    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    raw = random_scene(3000, seed=2, sh_degree=1, extent=1.5)
    rng = np.random.default_rng(2)
    state = state_from_numpy(dict(
        xyz=raw["xyz"], features_dc=raw["sh"][:, :1], features_rest=raw["sh"][:, 1:],
        scaling=raw["scaling"] - 1.0, rotation=raw["rotation"], opacity=raw["opacity"],
        refl=raw["refl"] + 2.0, texture=rng.uniform(-0.5, 0.5, (6, 3, 8, 8)).astype(np.float32),
        fail_value=np.zeros(3, np.float32), alive=np.ones(3000, bool),
        active_sh_degree=1, max_sh_degree=1), device=dev)
    opt = OptimizationParams()
    ts = TrainState.create(state, opt, num_frames=2)
    ts.step = opt.init_until_iter
    cam = orbit_camera(192, 256, radius=4.0, azimuth=0.5, elevation=0.2, device=dev)
    gt = torch.rand((192, 256, 3), generator=torch.Generator().manual_seed(5)).to(dev)
    bg = torch.tensor([0.1, 0.2, 0.3], device=dev)
    cfg = production_config(max_tiles_per_gaussian=16, max_instances=1 << 16, tile_depth=512,
                            chunk=16)
    kw = dict(use_env_scope=True, env_scope_center=(0.0, 0.0, 0.0), env_scope_radius=1.0,
              isp_cfg=ISPConfig(controller_activation_ratio=0.875))
    _, a1 = make_train_step(opt, cfg, 1.0, **kw)(ts, cam, gt, bg, frame_idx=1)
    LAUNCHES.clear()
    new, a2 = make_train_step(opt, cfg, 1.0, mesh=make_mesh(n, "tiles"), **kw)(
        ts, cam, gt, bg, frame_idx=1)
    launches = dict(LAUNCHES)
    digest = hashlib.sha256()
    for v in new.gaussians.param_pytree().values():
        digest.update(v.detach().cpu().numpy().tobytes())
    return dict(
        loss=(float(a1.loss), float(a2.loss)),
        render_err=float((a1.render - a2.render).abs().max()),
        grad_err={k: float((a2.grads[k] - g).abs().max() / g.abs().max().clamp(min=1e-30))
                  for k, g in a1.grads.items()},
        launches=launches, params_hash=digest.hexdigest())
