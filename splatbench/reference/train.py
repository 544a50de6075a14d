"""Plain PyTorch reference of the training step: the frame of `splat.py`
with autograd, the learned per-frame ISP, L1 + SSIM, the normal-consistency
loss, the ISP regularisation, and Adam under the fork's schedule.

The gradient of the blend comes from autograd one tile batch at a time
(`splat.blend_backward`): the image-space part of the loss is
differentiated once in its maps, and that cotangent is pulled back through
each batch of tiles. Imports nothing of the program.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from splatbench.reference import splat
from splatbench.reference.splat import Binning, Precision, matmul, mm_operand

GAUSSIAN_LEAVES = ("xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity",
                   "refl")
ISP_LEAVES = ("isp_gain", "isp_bias", "isp_log_gamma", "isp_ctrl_gain", "isp_ctrl_bias",
              "isp_ctrl_log_gamma", "isp_vig_coef", "isp_vig_center")
LEAVES = GAUSSIAN_LEAVES + ("env_texture", "env_fail") + ISP_LEAVES
B1, B2, ADAM_EPS = 0.9, 0.999, 1e-15


def lr_group(leaf: str) -> str:
    if leaf.startswith("isp_"):
        return "isp"
    return {"features_dc": "f_dc", "features_rest": "f_rest", "env_texture": "env",
            "env_fail": "env"}.get(leaf, leaf)


def learning_rates(opt: dict, step: int, extent: float) -> dict:
    """The per-group rates of step `step` (1-based) of the fork's schedule,
    outside the xyz freeze and the scene freeze: the position rate decays
    log-linearly from position_lr_init to position_lr_final (times the
    scene extent) over position_lr_max_steps."""
    t = min(max(step / opt["position_lr_max_steps"], 0.0), 1.0)
    xyz = math.exp(math.log(np.float32(opt["position_lr_init"] * extent)) * (1 - t)
                   + math.log(np.float32(opt["position_lr_final"] * extent)) * t)
    lrs = dict(xyz=xyz, f_dc=opt["feature_lr"], f_rest=opt["feature_lr"] / 20.0,
               opacity=opt["opacity_lr"], scaling=opt["scaling_lr"], rotation=opt["rotation_lr"],
               refl=opt["refl_lr"], env=opt["envmap_cubemap_lr"], isp=opt["isp_lr"])
    return {k: float(np.float32(v)) for k, v in lrs.items()}


def isp_init(n_frames: int, device) -> dict:
    eye = torch.eye(3, device=device)
    z = lambda *s: torch.zeros(s, device=device)
    return dict(isp_gain=eye[None].repeat(n_frames, 1, 1), isp_bias=z(n_frames, 3),
                isp_log_gamma=z(n_frames, 3), isp_ctrl_gain=eye.clone(), isp_ctrl_bias=z(3),
                isp_ctrl_log_gamma=z(3), isp_vig_coef=z(1, 2), isp_vig_center=z(1, 2))


def apply_isp(p: dict, rgb: torch.Tensor, frame: int, prec: Precision) -> torch.Tensor:
    """The frame's colour matrix, bias and tone exponent after the radial
    vignette of camera 0."""
    H, W = rgb.shape[:2]
    dev = rgb.device
    x = torch.arange(W, dtype=torch.float32, device=dev) + 0.5
    y = torch.arange(H, dtype=torch.float32, device=dev) + 0.5
    pix = torch.stack(torch.meshgrid(x, y, indexing="xy"), -1)
    wh = torch.tensor([float(W), float(H)], device=dev)
    center = (0.5 + p["isp_vig_center"][0]) * wh
    r2 = torch.sum(((pix - center) / (0.5 * torch.sqrt(torch.sum(wh ** 2)))) ** 2, -1)
    a1, a2 = p["isp_vig_coef"][0, 0], p["isp_vig_coef"][0, 1]
    rgb = rgb * (1.0 + a1 * r2 + a2 * r2 * r2)[..., None]
    out = matmul(rgb, p["isp_gain"][frame].T, prec) + p["isp_bias"][frame]
    gamma = torch.exp(p["isp_log_gamma"][frame])
    base = torch.maximum(out, torch.zeros_like(out))  # a tie passes half the gradient
    steep = (base == 0) & (gamma < 1)
    return torch.where(steep, torch.zeros_like(base),
                       torch.where(steep, torch.ones_like(base), base) ** gamma)


def isp_regularization(p: dict, reg_weight=1e-3, distill_weight=1e-2) -> torch.Tensor:
    eye = torch.eye(3, device=p["isp_gain"].device)
    reg = (torch.mean((p["isp_gain"] - eye) ** 2) + torch.mean(p["isp_bias"] ** 2)
           + torch.mean(p["isp_log_gamma"] ** 2) + torch.mean(p["isp_vig_coef"] ** 2)
           + torch.mean(p["isp_vig_center"] ** 2))
    distill = (torch.mean((p["isp_ctrl_gain"] - p["isp_gain"].mean(0)) ** 2)
               + torch.mean((p["isp_ctrl_bias"] - p["isp_bias"].mean(0)) ** 2)
               + torch.mean((p["isp_ctrl_log_gamma"] - p["isp_log_gamma"].mean(0)) ** 2))
    return reg_weight * reg + distill_weight * distill


def ssim(a: torch.Tensor, b: torch.Tensor, prec: Precision) -> torch.Tensor:
    """Mean SSIM of [H, W, C] images: Gaussian window 11, sigma 1.5, zero
    padded, C1 = 0.01^2, C2 = 0.03^2."""
    x = torch.arange(11, dtype=torch.float32, device=a.device) - 5
    g = torch.exp(-(x ** 2) / (2 * 1.5 ** 2))
    g = g / g.sum()
    C = a.shape[-1]
    w = mm_operand(torch.outer(g, g), prec)[None, None].expand(C, 1, 11, 11)
    conv = lambda t: F.conv2d(mm_operand(t, prec).permute(2, 0, 1)[None], w, padding=5,
                              groups=C)[0]
    mu1, mu2 = conv(a), conv(b)
    s11 = conv(a * a) - mu1 * mu1
    s22 = conv(b * b) - mu2 * mu2
    s12 = conv(a * b) - mu1 * mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    m = ((2 * mu1 * mu2 + c1) * (2 * s12 + c2)) / ((mu1 * mu1 + mu2 * mu2 + c1) * (s11 + s22 + c2))
    return m.mean()


def loss_and_grads(p: dict, cam: dict, gt: torch.Tensor, bg: torch.Tensor, frame: int,
                   opt: dict, prec: Precision, binning: Binning, fault: str = ""):
    """One step's objective and the gradient of every leaf of `p`.
    `fault="half_batch"` takes the image-space means over the top half of
    the rows only (a planted fault). -> (loss, {leaf: gradient})."""
    gauss = {k: p[k].detach().requires_grad_(True) for k in GAUSSIAN_LEAVES}
    rest = {k: p[k].detach().requires_grad_(True) for k in LEAVES if k not in gauss}
    with torch.enable_grad():
        pre = splat.preprocess({**gauss, "alive": p["alive"]}, cam, prec, binning)
        rows = splat.surfel_rows(pre, prec)
    gid, _, starts, counts = splat.bin_instances(pre, binning)
    inst = rows.detach()[gid]
    H, W = cam["height"], cam["width"]
    maps, _ = splat.rasterize(inst, starts, counts, pre["tiles"], H, W)
    maps = maps.clone().requires_grad_(True)
    with torch.enable_grad():
        m = torch.cat([maps[..., 0:3] + maps[..., 3:4] * bg, maps[..., 3:]], -1)
        out = splat.reflect_shade(m, rest["env_texture"], rest["env_fail"], cam, prec, True)
        rgb = apply_isp(rest, out["render"], frame, prec)
        target = gt
        if fault == "half_batch":
            rgb, target = rgb[: H // 2], gt[: H // 2]
        l1 = torch.mean(torch.abs(rgb - target))
        loss = (1.0 - opt["lambda_dssim"]) * l1 + opt["lambda_dssim"] * (
            1.0 - ssim(rgb, target, prec))
        nerr = 1.0 - torch.sum(out["normal"] * out["surf_normal"], -1)
        if fault == "half_batch":
            nerr = nerr[: H // 2]
        loss = loss + opt["lambda_normal"] * torch.mean(nerr) + isp_regularization(rest)
        names = list(rest)
        got = torch.autograd.grad(loss, [maps] + [rest[k] for k in names])
    d_inst = splat.blend_backward(inst, starts, counts, pre["tiles"], H, W, got[0])
    if prec.bf16_grads:
        d_inst = d_inst.to(torch.bfloat16).to(torch.float32)
    d_rows = torch.zeros_like(rows).index_add_(0, gid, d_inst)
    g_gauss = torch.autograd.grad(rows, [gauss[k] for k in GAUSSIAN_LEAVES], d_rows,
                                  allow_unused=True)
    grads = {k: torch.zeros_like(gauss[k]) if g is None else g
             for k, g in zip(GAUSSIAN_LEAVES, g_gauss)}
    grads.update(zip(names, got[1:]))
    return float(loss.detach()), grads


@torch.no_grad()
def adam(p: dict, grads: dict, state: dict, lrs: dict) -> dict:
    """One Adam step (betas 0.9, 0.999, eps 1e-15 outside the root, bias
    correction by the step count) on every leaf; updates `state` in place
    and returns the new leaves."""
    c = state["count"] = state["count"] + 1
    bc1 = float(np.float32(1.0) - np.float32(B1) ** np.float32(c))
    bc2 = float(np.float32(1.0) - np.float32(B2) ** np.float32(c))
    out = dict(p)
    for k in LEAVES:
        g = grads[k]
        mu = state["mu"][k] = B1 * state["mu"][k] + (1 - B1) * g
        nu = state["nu"][k] = B2 * state["nu"][k] + (1 - B2) * g * g
        out[k] = p[k] - lrs[lr_group(k)] * ((mu / bc1) / (torch.sqrt(nu / bc2) + ADAM_EPS))
    return out


def run_steps(p0: dict, steps: list, bg, opt: dict, extent: float, first_step: int,
              prec: Precision, binning: Binning, fault: str = ""):
    """Follow the program's first steps from the same leaves `p0`; `steps`
    holds (camera dict, ground truth [H, W, 3], frame index) per step.
    -> dict(losses, grad_norms (per step, per leaf), params after the last
    step)."""
    p = {k: v for k, v in p0.items()}
    state = dict(count=0, mu={k: torch.zeros_like(p[k]) for k in LEAVES},
                 nu={k: torch.zeros_like(p[k]) for k in LEAVES})
    losses, norms = [], []
    for i, (cam, gt, frame) in enumerate(steps):
        loss, grads = loss_and_grads(p, cam, gt, bg, frame, opt, prec, binning, fault)
        losses.append(loss)
        norms.append({k: float(torch.linalg.vector_norm(grads[k].double())) for k in LEAVES})
        p = adam(p, grads, state, learning_rates(opt, first_step + i + 1, extent))
        del grads
    return dict(losses=losses, grad_norms=norms, params=p)
