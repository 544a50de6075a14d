"""End-to-end convergence certificate (port of the root validate_e2e.py).

    python -m tpu_splat_torch.scripts.validate_e2e --task recover|scratch|recover_vol \
        [--out F] [--iterations N] [--save_state P] [--device cuda|cpu]

Three tasks at 256x256 under the shipped production switches
(`raster/config.py:production_config`, backend="pallas": the tile kernels);
the ground truth is rendered by the port itself from a structured scene
(floor plane, reflective sphere, matte ellipsoid), so no dataset is needed:

  recover      every parameter of the ground truth jittered, 2,500 steps
               without densify; bars: train >= 35 dB, held-out >= 30 dB,
               held-out SSIM >= 0.95.
  scratch      10,000 steps from a noisy surface point cloud with every
               scheduled event (densify, resets, normal propagation, colour
               sabotage, env doubling); bars: held-out >= 30 dB, SSIM >= 0.90.
  recover_vol  the scene as volumetric (3DGS EWA) splats, jittered, 2,000
               steps of plain Adam on 0.8 L1 + 0.2 (1 - SSIM); bars: train
               >= 32 dB, held-out >= 29 dB, SSIM >= 0.93.

E2E_SMOKE=1 runs a tiny version (64x64, 40 iterations, float32 switches).
The artifact (`--out`) has the JAX script's fields; `backend` is "gpu" on
the card and `device` the card's name and power limit as nvidia-smi gives
them. The scheduled events draw from `TrainState.generator`, not from
`jax.random` (whose bits torch cannot reproduce).
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from tpu_splat_torch.core import f32
from tpu_splat_torch.core.device import device_names, resolve_device
from tpu_splat_torch.core.sh import num_sh_coeffs, rgb_to_sh
from tpu_splat_torch.data.synthetic import orbit_camera
from tpu_splat_torch.envmap.cubemap import CubemapParams
from tpu_splat_torch.eval.lpips import gmsd
from tpu_splat_torch.model.state import GaussianState
from tpu_splat_torch.raster.config import production_config, production_switches
from tpu_splat_torch.renderer.render import render
from tpu_splat_torch.train.losses import ssim

BARS = {
    "recover": {"train": 35.0, "held_out": 30.0, "ssim_held_out": 0.95},
    "scratch": {"held_out": 30.0, "ssim_held_out": 0.90},
    "recover_vol": {"train": 32.0, "held_out": 29.0, "ssim_held_out": 0.93},
}
VOL_LR = {"xyz": 2e-4, "scl": 2e-3, "rot": 1e-3, "opa": 2e-2, "col": 5e-3, "rfl": 0.0}
NOTE = (
    "Known-GT scene rendered by this renderer, so no dataset is needed. "
    "'recover' certifies gradient/optimizer fidelity at "
    "convergence precision; 'scratch' certifies the full schedule (densify, normal "
    "propagation, color sabotage, env doubling) on a learnable surface scene. Config "
    "block == scripts/train.py defaults (one config story)."
)
VOL_NOTE = (
    "Trained certification of the volumetric rasterizer path: GT rendered by the "
    "same path, all parameters jittered, plain Adam recovery."
)


def smoke() -> bool:
    """E2E_SMOKE=1: the tiny CPU version of each task."""
    return os.environ.get("E2E_SMOKE", "") == "1"


def _normal_quats(normals: np.ndarray) -> np.ndarray:
    """Quaternions (w,x,y,z) rotating e_z to each normal -- the surfel's
    zero-thickness axis is the third column of R (preprocess.py)."""
    n = normals / np.linalg.norm(normals, axis=-1, keepdims=True)
    ez = np.array([0.0, 0.0, 1.0])
    axis = np.cross(np.broadcast_to(ez, n.shape), n)
    s = np.linalg.norm(axis, axis=-1, keepdims=True)
    c = n[:, 2:3]
    # halve the angle: q = (cos(a/2), axis_hat * sin(a/2))
    w = np.sqrt(np.maximum((1.0 + c) / 2.0, 0.0))
    sin_half = np.sqrt(np.maximum((1.0 - c) / 2.0, 0.0))
    axis_hat = np.where(s > 1e-8, axis / np.maximum(s, 1e-12), ez)
    q = np.concatenate([w, axis_hat * sin_half], axis=1)
    # antiparallel normal (c ~ -1): rotate pi about x
    q = np.where(c < -1.0 + 1e-8, np.array([[0.0, 1.0, 0.0, 0.0]]), q)
    return q.astype(np.float32)


def make_structured_scene(smoke: bool = False) -> dict:
    """Surface-structured GT scene: floor plane + reflective sphere + matte
    ellipsoid, smooth colour fields, surfel normals on the surfaces. Returns
    the raw parameters (xyz, rotation, scaling, opacity, sh, refl) and the
    colours, as numpy float32."""
    k = 0.35 if smoke else 1.0
    rng = np.random.default_rng(11)

    parts = []

    # floor plane y = -1.2 over [-2, 2]^2
    g = int(56 * k) | 1
    u = np.linspace(-2.0, 2.0, g)
    xx, zz = np.meshgrid(u, u, indexing="ij")
    fl_xyz = np.stack([xx, np.full_like(xx, -1.2), zz], -1).reshape(-1, 3)
    fl_n = np.tile([0.0, 1.0, 0.0], (len(fl_xyz), 1))
    fl_col = np.stack(
        [
            0.45 + 0.3 * np.sin(1.7 * fl_xyz[:, 0]) * np.cos(1.3 * fl_xyz[:, 2]),
            0.5 + 0.25 * np.cos(1.1 * fl_xyz[:, 0] + 0.8 * fl_xyz[:, 2]),
            0.55 + 0.3 * np.sin(0.9 * fl_xyz[:, 2]),
        ],
        axis=1,
    )
    fl_scale = np.full((len(fl_xyz), 2), np.log(4.4 / g))
    fl_refl = np.full((len(fl_xyz), 1), -4.0)
    parts.append((fl_xyz, fl_n, fl_col, fl_scale, fl_refl))

    # reflective sphere r=0.7 at (0, -0.25, 0) -- fibonacci lattice
    m = int(2400 * k * k)
    i = np.arange(m) + 0.5
    phi = np.arccos(1 - 2 * i / m)
    theta = np.pi * (1 + 5**0.5) * i
    sp_n = np.stack(
        [np.sin(phi) * np.cos(theta), np.cos(phi), np.sin(phi) * np.sin(theta)],
        axis=1,
    )
    sp_xyz = np.array([0.0, -0.25, 0.0]) + 0.7 * sp_n
    ang = np.arctan2(sp_n[:, 2], sp_n[:, 0])
    sp_col = np.stack(
        [
            0.55 + 0.25 * np.sin(2 * ang),
            0.5 + 0.25 * np.cos(3 * sp_n[:, 1]),
            0.6 + 0.2 * np.sin(2 * sp_n[:, 1] + ang),
        ],
        axis=1,
    )
    sp_scale = np.full((m, 2), np.log(0.055 / k))
    sp_refl = np.full((m, 1), 1.5)  # sigmoid ~ 0.82: exercises deferred env
    parts.append((sp_xyz, sp_n, sp_col, sp_scale, sp_refl))

    # matte ellipsoid at (1.1, -0.75, 0.5), semi-axes (0.35, 0.45, 0.35)
    m2 = int(1000 * k * k)
    i = np.arange(m2) + 0.5
    phi = np.arccos(1 - 2 * i / m2)
    theta = np.pi * (1 + 5**0.5) * i
    n2 = np.stack(
        [np.sin(phi) * np.cos(theta), np.cos(phi), np.sin(phi) * np.sin(theta)],
        axis=1,
    )
    ax = np.array([0.35, 0.45, 0.35])
    el_xyz = np.array([1.1, -0.75, 0.5]) + ax * n2
    el_n = n2 / ax  # gradient of the implicit ellipsoid
    el_n /= np.linalg.norm(el_n, axis=-1, keepdims=True)
    el_col = np.stack(
        [
            0.7 + 0.15 * np.sin(4 * n2[:, 1]),
            0.35 + 0.1 * np.cos(3 * theta[:m2] / np.pi),
            0.3 + 0.1 * n2[:, 1],
        ],
        axis=1,
    )
    el_scale = np.full((m2, 2), np.log(0.05 / k))
    el_refl = np.full((m2, 1), -4.0)
    parts.append((el_xyz, el_n, el_col, el_scale, el_refl))

    xyz = np.concatenate([p[0] for p in parts]).astype(np.float32)
    nrm = np.concatenate([p[1] for p in parts]).astype(np.float32)
    col = np.concatenate([p[2] for p in parts]).astype(np.float32)
    scl = np.concatenate([p[3] for p in parts]).astype(np.float32)
    rfl = np.concatenate([p[4] for p in parts]).astype(np.float32)
    col = np.clip(col, 0.02, 0.98)

    n = len(xyz)
    msh = num_sh_coeffs(3)
    sh = np.zeros((n, msh, 3), np.float32)
    sh[:, 0] = rgb_to_sh(col)
    sh[:, 1:] = 0.03 * rng.normal(size=(n, msh - 1, 3))

    return dict(
        xyz=xyz,
        rotation=_normal_quats(nrm),
        scaling=scl,
        opacity=np.full((n, 1), 4.0, np.float32),  # sigmoid ~ 0.982
        sh=sh.astype(np.float32),
        refl=rfl,
        colors=col,
    )


def gt_texture(resolution: int) -> np.ndarray:
    """The ground truth's cubemap [6, 3, L, L]: smooth fields, every face and
    channel set (the JAX script overwrites a drawn texture entirely)."""
    u = np.linspace(-1, 1, resolution)
    uu, vv = np.meshgrid(u, u, indexing="ij")
    tex = np.empty((6, 3, resolution, resolution), np.float32)
    for f in range(6):
        tex[f, 0] = 2.0 * np.sin(3 * uu + f)
        tex[f, 1] = 2.0 * np.cos(2 * vv - f)
        tex[f, 2] = 1.5 * np.sin(2 * uu * vv + 0.5 * f)
    return tex


def build_gt_state(smoke: bool, device="cuda") -> tuple[GaussianState, dict]:
    """-> (the ground-truth GaussianState on `device`, the scene dict)."""
    dev = resolve_device(device)
    sc = make_structured_scene(smoke)
    n = len(sc["xyz"])
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    env = CubemapParams(texture=t(gt_texture(16 if smoke else 32)),
                        fail_value=torch.zeros((3,), device=dev))
    state = GaussianState(
        xyz=t(sc["xyz"]),
        features_dc=t(sc["sh"][:, :1]),
        features_rest=t(sc["sh"][:, 1:]),
        scaling=t(sc["scaling"]),
        rotation=t(sc["rotation"]),
        opacity=t(sc["opacity"]),
        refl=t(sc["refl"]),
        env=env,
        alive=torch.ones((n,), dtype=torch.bool, device=dev),
        active_sh_degree=3,
        max_sh_degree=3,
    )
    return state, sc


def make_cameras(H, W, n_views, n_test, device="cuda"):
    total = n_views + n_test
    return [
        orbit_camera(
            H, W, radius=4.2,
            azimuth=2 * np.pi * i / total,
            elevation=0.30 + 0.22 * np.sin(2.2 * i),
            target=(0.2, -0.45, 0.1),
            device=device,
        )
        for i in range(total)
    ]


def task_config(smoke: bool):
    """THE shipped switch block; only capacities are sized to the workload
    (float32 switches under smoke)."""
    return production_config(
        max_tiles_per_gaussian=16 if smoke else 64,
        max_instances=1 << (14 if smoke else 20),
        tile_depth=256 if smoke else 1024,
        chunk=16 if smoke else 32,
        backend="pallas",
        **(dict(grad_channels="full", bf16_grads=False, bf16_feats=False) if smoke else {}),
    )


def _host(img: torch.Tensor) -> np.ndarray:
    return img.detach().cpu().numpy()


def psnr(a, b) -> float:
    return float(-10 * np.log10(np.mean((np.asarray(a) - b) ** 2) + 1e-12))


def score(render_fn, cams, gts, n_views, n_test):
    """-> (train PSNR over every (n_views // 6)-th train view, held-out
    per-view PSNR, SSIM and GMSD); render_fn(camera) -> [H, W, 3]."""
    with torch.no_grad():
        tr = [psnr(_host(render_fn(cams[i])), gts[i])
              for i in range(0, n_views, max(n_views // 6, 1))]
        te, te_ssim, te_gmsd = [], [], []
        for i in range(n_views, n_views + n_test):
            img = render_fn(cams[i])
            gt = torch.as_tensor(gts[i], device=img.device)
            te.append(psnr(_host(img), gts[i]))
            te_ssim.append(float(ssim(img, gt)))
            te_gmsd.append(float(gmsd(img, gt)))
    return float(np.mean(tr)), te, te_ssim, te_gmsd


def evaluate(cfg, bg, gaussians, cams, gts, n_views, n_test):
    """-> (train PSNR, held-out per-view PSNR, SSIM, GMSD) of the deferred
    render."""
    return score(lambda c: render(gaussians, c, cfg, bg, initial_stage=False).render,
                 cams, gts, n_views, n_test)


def view_order(n_views: int, iterations: int, seed: int) -> list[int]:
    """The training views, a fresh permutation from default_rng(seed) each
    pass over the views (the JAX script draws the first one twice)."""
    rng = np.random.default_rng(seed)
    order = rng.permutation(n_views)
    out = []
    for it in range(1, iterations + 1):
        if (it - 1) % n_views == 0:
            order = rng.permutation(n_views)
        out.append(int(order[(it - 1) % n_views]))
    return out


def train_loop(step_fn, ts, opt, cams, gts, n_views, bg, log, curve, draws=None,
               on_step=None):
    """opt.iterations steps, each the train step and then the scheduled
    events; the train PSNR every 500 iterations and at the first goes to
    `curve`. `draws` hands the events their draws (default: the state's
    generator); `on_step(it, aux)` is called with (0, None) before the
    first step and then after every step with its aux."""
    from tpu_splat_torch.train.loop import run_scheduled_events

    t0 = time.time()
    if on_step is not None:
        on_step(0, None)
    for it, vi in enumerate(view_order(n_views, opt.iterations, 5), start=1):
        ts, aux = step_fn(ts, cams[vi], gts[vi], bg)
        if on_step is not None:
            on_step(it, aux)
        ts = run_scheduled_events(ts, it, opt, cameras_extent=2.6,
                                  cameras_mean=np.zeros(3), log=log, draws=draws)
        if it % 500 == 0 or it == 1:
            curve.append((it, round(float(aux.psnr), 3)))
            print(f"it {it:5d} loss {float(aux.loss):.4f} psnr {float(aux.psnr):5.2f} "
                  f"alive {int(aux.n_alive)} inst {int(aux.num_instances)} "
                  f"({time.time() - t0:.0f}s)", flush=True)
    return ts, time.time() - t0


def recover_state(gt_state: GaussianState, rng) -> GaussianState:
    """Every ground-truth parameter jittered (numpy draws from `rng`, in the
    JAX script's order), padded to the next power of two: padding rows are
    dead, with scaling / opacity / refl -10 and an identity rotation."""
    dev = gt_state.device
    n_gt = gt_state.capacity
    cap = 1 << int(np.ceil(np.log2(n_gt)))
    gt = {k: _host(getattr(gt_state, k)) for k in
          ("xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity", "refl")}
    scale_sigma = np.exp(gt["scaling"]).mean(axis=1, keepdims=True)

    def pad(a, fill=0.0):
        out = np.full((cap,) + a.shape[1:], fill, np.float32)
        out[:n_gt] = np.asarray(a)
        return out

    pert = dict(
        xyz=gt["xyz"] + 0.5 * scale_sigma * rng.normal(size=(n_gt, 3)),
        features_dc=gt["features_dc"] + 0.15 * rng.normal(size=(n_gt, 1, 3)),
        features_rest=gt["features_rest"] + 0.05 * rng.normal(size=gt["features_rest"].shape),
        scaling=gt["scaling"] + 0.2 * rng.normal(size=(n_gt, 2)),
        rotation=gt["rotation"] + 0.08 * rng.normal(size=(n_gt, 4)),
        opacity=gt["opacity"] + 0.75 * rng.normal(size=(n_gt, 1)),
        refl=gt["refl"] + 0.5 * rng.normal(size=(n_gt, 1)),
    )
    tex = _host(gt_state.env.texture)
    tex = tex + np.float32(0.3) * rng.normal(size=tex.shape).astype(np.float32)
    rot = pad(pert["rotation"])
    rot[n_gt:, 0] = 1.0
    alive = np.zeros(cap, bool)
    alive[:n_gt] = True
    t = lambda a: torch.as_tensor(a, device=dev)
    return GaussianState(
        xyz=t(pad(pert["xyz"])),
        features_dc=t(pad(pert["features_dc"])),
        features_rest=t(pad(pert["features_rest"])),
        scaling=t(pad(pert["scaling"], fill=-10.0)),
        rotation=t(rot),
        opacity=t(pad(pert["opacity"], fill=-10.0)),
        refl=t(pad(pert["refl"], fill=-10.0)),
        env=CubemapParams(texture=t(tex), fail_value=gt_state.env.fail_value.clone()),
        alive=t(alive),
        active_sh_degree=3,
        max_sh_degree=3,
    )


def recover_schedule(opt, iterations: int):
    """The recover task's OptimizationParams edits: no densify, resets,
    propagation or sabotage; geometry never frozen."""
    opt.iterations = iterations
    opt.init_until_iter = 0
    opt.densify_from_iter = 10**9
    opt.densify_until_iter = 0
    opt.opacity_reset_interval = 10**9
    opt.disable_normal_propagation = True
    opt.disable_color_sabotage = True
    opt.opac_lr0_interval = 0
    opt.feature_rest_from_iter = 0
    opt.freeze_xyz_last_iters = 0  # geometry must move to recover
    opt.position_lr_max_steps = opt.iterations
    return opt


def scratch_schedule(opt, iterations: int):
    """The scratch task's schedule, every window scaled to `iterations`."""
    opt.iterations = it = iterations
    opt.init_until_iter = max(it // 33, 3)
    opt.densify_from_iter = max(it // 20, 5)
    opt.densify_until_iter = it // 2
    opt.opacity_reset_interval = max(3 * it // 10, 10)
    opt.normal_prop_until_iter = 3 * it // 5
    opt.color_sabotage_until_iter = 3 * it // 5
    opt.normal_prop_interval = max(it // 20, 5)
    opt.color_sabotage_interval = max(it // 20, 5)
    opt.feature_rest_from_iter = it // 5
    opt.freeze_xyz_last_iters = it // 4  # reference ratio (10k of 40k)
    opt.position_lr_max_steps = it
    return opt


def verdict_of(bars: dict, tr: float, te: float, ssim_m: float) -> str:
    ok = (te >= bars["held_out"] and tr >= bars.get("train", 0.0)
          and ssim_m >= bars.get("ssim_held_out", 0.0))
    return "PASS" if ok else "BELOW-BAR"


def _write(path: str, artifact: dict) -> None:
    with open(path, "w") as f:
        json.dump(artifact, f, indent=1)
    print(f"wrote {path}", flush=True)


def vol_scene(smoke: bool, device):
    """-> (the ground-truth volumetric leaves, the per-Gaussian normals):
    the surfel scene's two tangential axes and a thin third one (0.25x)
    along the normal, refl logit -4."""
    from tpu_splat_torch.core.transforms import quat_to_rotmat

    sc = make_structured_scene(smoke)
    n = len(sc["xyz"])
    scl3 = np.concatenate(
        [sc["scaling"], sc["scaling"].mean(1, keepdims=True) + np.log(0.25)], axis=1,
    ).astype(np.float32)
    gt = dict(xyz=sc["xyz"], scl=scl3, rot=sc["rotation"], opa=sc["opacity"][:, 0],
              col=sc["colors"], rfl=np.full((n,), -4.0, np.float32))
    normals = quat_to_rotmat(torch.as_tensor(sc["rotation"], device=device))[:, :, 2]
    return gt, normals


def vol_perturb(gt: dict, rng) -> dict:
    """The recover_vol jitter, numpy draws from `rng` in the JAX script's
    order; rfl stays."""
    n = len(gt["xyz"])
    ssig = np.exp(gt["scl"]).mean(axis=1, keepdims=True)
    return {
        "xyz": gt["xyz"] + 0.5 * ssig * rng.normal(size=(n, 3)).astype(np.float32),
        "scl": gt["scl"] + 0.2 * rng.normal(size=(n, 3)).astype(np.float32),
        "rot": gt["rot"] + 0.08 * rng.normal(size=(n, 4)).astype(np.float32),
        "opa": gt["opa"] + 0.75 * rng.normal(size=(n,)).astype(np.float32),
        "col": np.clip(gt["col"] + 0.15 * rng.normal(size=(n, 3)), 0, 1).astype(np.float32),
        "rfl": gt["rfl"],
    }


def render_vol(p: dict, normals, camera, bg, cfg) -> torch.Tensor:
    """The volumetric colour image of leaves `p` (raw: log-scales, logits)."""
    from tpu_splat_torch.raster import rasterize

    return rasterize(p["xyz"], f32.exp(p["scl"]), p["rot"], f32.sigmoid(p["opa"]),
                     f32.sigmoid(p["rfl"]), camera, bg, cfg, colors=p["col"],
                     mode="volumetric", normals=normals).color


def vol_optimizer(params: dict) -> torch.optim.Adam:
    """Plain Adam per leaf at VOL_LR (optax.adam's b1, b2 and eps are
    torch's defaults); rfl, at rate 0, is frozen."""
    return torch.optim.Adam([{"params": [params[k]], "lr": lr}
                             for k, lr in VOL_LR.items() if lr])


def vol_loss(img, gt_img):
    return 0.8 * torch.mean(torch.abs(img - gt_img)) + 0.2 * (1.0 - ssim(img, gt_img))


def run_recover_vol(args, dev, on_step=None) -> str:
    """Perturbation recovery through the volumetric (3DGS EWA) rasterizer:
    ground truth rendered by rasterize(mode="volumetric") itself, every
    parameter jittered, plain Adam on L1 + SSIM. `on_step(it, loss)` is
    called with (0, None) before the first step and after every step."""
    sm = smoke()
    H = W = 64 if sm else 256
    cfg = task_config(sm)
    gt, normals = vol_scene(sm, dev)
    n = len(gt["xyz"])
    n_views, n_test = (8, 2) if sm else (24, 4)
    cams = make_cameras(H, W, n_views, n_test, device=dev)
    bg = torch.zeros(3, device=dev)
    rj = lambda p, c: render_vol(p, normals, c, bg, cfg)

    gt_p = {k: torch.as_tensor(v, device=dev) for k, v in gt.items()}
    print(f"rendering {n_views + n_test} volumetric GT views...", flush=True)
    with torch.no_grad():
        gts = [_host(rj(gt_p, c)) for c in cams]
    gts_dev = [torch.as_tensor(g, device=dev) for g in gts]

    pert = vol_perturb(gt, np.random.default_rng(13))
    params = {k: torch.as_tensor(v, device=dev).requires_grad_(VOL_LR[k] > 0)
              for k, v in pert.items()}
    opt = vol_optimizer(params)
    iters = args.iterations or (40 if sm else 2000)

    t0 = time.time()
    if on_step is not None:
        on_step(0, None)
    for it, vi in enumerate(view_order(n_views, iters, 3), start=1):
        opt.zero_grad(set_to_none=True)
        loss = vol_loss(rj(params, cams[vi]), gts_dev[vi])
        loss.backward()
        opt.step()
        if on_step is not None:
            on_step(it, loss.detach())
        if it % 250 == 0 or it == 1:
            print(f"it {it:5d} loss {float(loss.detach()):.4f} ({time.time() - t0:.0f}s)",
                  flush=True)

    tr, te_l, te_s, te_g = score(lambda c: rj(params, c), cams, gts, n_views, n_test)
    te, ssim_m = float(np.mean(te_l)), float(np.mean(te_s))
    bars = BARS["recover_vol"]
    verdict = verdict_of(bars, tr, te, ssim_m)
    print(f"[volumetric] train PSNR {tr:.2f} held-out {te:.2f} SSIM {ssim_m:.4f} "
          f"GMSD {np.mean(te_g):.4f} -> {verdict}", flush=True)
    if args.out:
        backend, device = device_names(dev)
        _write(args.out, {
            "task": "recover_vol",
            "backend": backend,
            "device": device,
            "config": production_switches(cfg),
            "workload": {
                "H": H, "W": W, "n_gaussians": n, "iterations": iters,
                "views": n_views, "held_out_views": n_test,
                "rasterizer": "volumetric (3DGS EWA, SURVEY 2.5)",
            },
            "train_view_psnr": round(tr, 3),
            "held_out_psnr": round(te, 3),
            "held_out_per_view": [round(x, 3) for x in te_l],
            "held_out_ssim": round(ssim_m, 4),
            "held_out_gmsd": round(float(np.mean(te_g)), 4),
            "bars": bars,
            "verdict": verdict,
            "wall_seconds": round(time.time() - t0, 1),
            "note": VOL_NOTE,
        })
    return verdict


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--task", choices=["recover", "scratch", "recover_vol"], default="scratch")
    ap.add_argument("--out", default=os.environ.get("VALID_OUT", ""))
    ap.add_argument("--iterations", type=int, default=0, help="override")
    ap.add_argument("--save_state", default="",
                    help="write the trained end state as PLY(+.map)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def main(argv=None, on_step=None) -> str:
    """Run one task; returns its verdict. `on_step` sees every training
    step: (it, StepAux) for recover and scratch, (it, loss) for
    recover_vol; (0, None) before the first."""
    from tpu_splat_torch.config import OptimizationParams
    from tpu_splat_torch.model.state import init_from_pcd
    from tpu_splat_torch.train.loop import EventLog
    from tpu_splat_torch.train.step import TrainState, make_train_step

    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    if args.task == "recover_vol":
        return run_recover_vol(args, dev, on_step)
    sm = smoke()
    H = W = 64 if sm else 256
    cfg = task_config(sm)
    gt_state, sc = build_gt_state(sm, dev)
    n_gt = len(sc["xyz"])
    n_views, n_test = (12, 2) if sm else (48, 6)
    cams = make_cameras(H, W, n_views, n_test, device=dev)
    bg = torch.zeros(3, device=dev)

    print(f"rendering {n_views + n_test} GT views of {n_gt} surfels...", flush=True)
    with torch.no_grad():
        gts = [_host(render(gt_state, c, cfg, bg, initial_stage=False).render) for c in cams]
    print(f"GT mean intensity {np.mean(gts):.3f}", flush=True)
    gts_dev = [torch.as_tensor(g, device=dev) for g in gts]

    opt = OptimizationParams()
    rng = np.random.default_rng(9)
    if args.task == "recover":
        recover_schedule(opt, args.iterations or (40 if sm else 2500))
        state = recover_state(gt_state, rng)
    else:
        scratch_schedule(opt, args.iterations or (40 if sm else 10_000))
        sel = rng.choice(n_gt, min(300 if sm else 3000, n_gt), replace=False)
        pts = sc["xyz"][sel] + rng.normal(0, 0.04, (len(sel), 3)).astype(np.float32)
        cols = np.clip(sc["colors"][sel] + 0.1 * rng.normal(size=(len(sel), 3)), 0, 1
                       ).astype(np.float32)
        state = init_from_pcd(pts, cols, capacity=1 << (9 if sm else 15),
                              cubemap_resolution=16 if sm else 32, max_sh_degree=3,
                              init_refl_value=opt.refl_init_value, device=dev)
    bars = BARS[args.task]
    del gt_state

    ts = TrainState.create(state, opt)
    step_fn = make_train_step(opt, cfg, spatial_lr_scale=4.2)
    log = EventLog()
    curve = []
    ts, wall = train_loop(step_fn, ts, opt, cams, gts_dev, n_views, bg, log, curve,
                          on_step=on_step)
    print(f"events: densified {log.densified} pruned {log.pruned} "
          f"overflow {log.overflowed} n_events {len(log.events)}", flush=True)

    if args.save_state:
        from tpu_splat_torch.model.io import save_ply

        save_ply(ts.gaussians, args.save_state)
        print(f"saved end state to {args.save_state}", flush=True)

    tr, te_list, te_ssim, te_gmsd = evaluate(cfg, bg, ts.gaussians, cams, gts, n_views, n_test)
    te, ssim_m, gmsd_m = (float(np.mean(x)) for x in (te_list, te_ssim, te_gmsd))
    print(f"train-view PSNR {tr:.2f}  held-out PSNR {te:.2f}  SSIM {ssim_m:.4f}  "
          f"GMSD {gmsd_m:.4f}", flush=True)
    verdict = verdict_of(bars, tr, te, ssim_m)
    print(verdict, flush=True)

    if args.out:
        backend, device = device_names(dev)
        _write(args.out, {
            "task": args.task,
            "backend": backend,
            "device": device,
            "raster_backend": "pallas",
            "config": production_switches(cfg),
            "workload": {
                "H": H, "W": W, "n_gt": n_gt, "iterations": opt.iterations,
                "sh_degree": 3, "max_instances": cfg.max_instances,
                "views": n_views, "held_out_views": n_test,
                "scene": "structured (floor plane + reflective sphere + matte ellipsoid)",
            },
            "psnr_curve": curve,
            "train_view_psnr": round(tr, 3),
            "held_out_psnr": round(te, 3),
            "held_out_per_view": [round(x, 3) for x in te_list],
            "held_out_ssim": round(ssim_m, 4),
            "held_out_ssim_per_view": [round(x, 4) for x in te_ssim],
            "held_out_gmsd": round(gmsd_m, 4),
            "held_out_gmsd_per_view": [round(x, 4) for x in te_gmsd],
            "bars": bars,
            "verdict": verdict,
            "events": {
                "densified": log.densified, "pruned": log.pruned,
                "overflowed": log.overflowed, "n_events": len(log.events),
            },
            "wall_seconds": round(wall, 1),
            "note": NOTE,
        })
    return verdict


if __name__ == "__main__":
    main()
