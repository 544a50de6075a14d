"""Plain PyTorch reference of the 3DGS-DR training step on volumetric 3D
Gaussians.

3D Gaussian Splatting with Deferred Reflection (Ye et al., SIGGRAPH 2024)
renders classic 3DGS Gaussians by EWA splatting (the vendored
diff-gaussian-rasterization, forward.cu: the 3D covariance R S S^T R^T, the
local affine Jacobian of the perspective at the frustum-clamped centre, the
2D covariance T Sigma T^T plus 0.3 px on its diagonal, the 3-sigma radius
ceil(3 sqrt(lambda_max)) and its square tile rect, alpha = min(0.99,
opacity exp(-d^T Sigma2D^-1 d / 2)) skipped below 1/255, front to back
until T falls below 1e-4), blends a per-Gaussian normal and reflection
strength into maps, and shades by deferred reflection: the camera ray
reflected about the rendered normal reads a learned cubemap, mixed over the
base colour by the rendered strength. Each Gaussian's normal is its
shortest axis, turned toward the camera.

Written from those equations in plain tensor operations and differentiated
by autograd; it imports nothing of the program. The 2D Gaussian is blended
by `splat.py`'s tile loop as an affine homography z [[A, mu], [0, 0, 1]]
with A A^T = Sigma2D (A the symmetric square root): the loop's ray-splat
solve then gives rho = d^T Sigma2D^-1 d and the depth z, and a low-pass
centre far off the image keeps its 2DGS floor out. The image-space part
(deferred reflection, the learned ISP, L1 + SSIM, the normal-consistency
loss, the ISP regularisation) and Adam are `train.py`'s.

Precision: float32 with TF32 off, as the configuration states; `Precision`
rounds every matrix-product operand to TF32 for the control, and the
training switches' bf16 content rows and gradient rows as `splat.py`
describes.

Departures from 3DGS-DR as published, each the port's trainer's:
- the loss is the fork's (gssales/gaussian-splatting-reflection): L1 +
  SSIM, the depth-derived normal consistency and the ISP regularisation,
  in place of 3DGS-DR's own terms and schedule;
- the learned per-frame ISP is on;
- the cubemap is read by one seamless bilinear tap through a sigmoid (no
  mip levels);
- the Mip-Splatting opacity rescale (antialiasing) is off, the vendored
  rasterizer's default.
"""
from __future__ import annotations

import torch

from splatbench.reference import splat
from splatbench.reference import train as ref_train
from splatbench.reference.splat import Precision, matmul
from splatbench.reference.train import GAUSSIAN_LEAVES, LEAVES

DILATION = 0.3
FAR_XY = 1e7  # the low-pass centre, far off any image


def shortest_axis_normals(R: torch.Tensor, scales: torch.Tensor, xyz: torch.Tensor,
                          center: torch.Tensor) -> torch.Tensor:
    """Column argmin(scales) of R, turned toward the camera centre; the
    choice and the sign carry no gradient."""
    with torch.no_grad():
        k = torch.argmin(scales, dim=-1)
    n = R[torch.arange(R.shape[0], device=R.device), :, k]
    with torch.no_grad():
        s = torch.where(torch.sum(n * (center - xyz), -1) < 0, -1.0, 1.0)
    return n * s[:, None]


def sqrtm_2x2(c: torch.Tensor) -> torch.Tensor:
    """Symmetric square root of SPD [P, 2, 2]: (C + sqrt(det) I) /
    sqrt(tr + 2 sqrt(det))."""
    det = c[:, 0, 0] * c[:, 1, 1] - c[:, 0, 1] * c[:, 1, 0]
    s = torch.sqrt(torch.clamp(det, min=1e-12))
    t = torch.sqrt(torch.clamp(c[:, 0, 0] + c[:, 1, 1] + 2 * s, min=1e-12))
    eye = torch.eye(2, device=c.device)
    return (c + s[:, None, None] * eye) / t[:, None, None]


def preprocess(p: dict, cam: dict, prec: Precision) -> dict:
    """Per-Gaussian screen quantities of the raw leaves `p` (scaling [P, 3]
    log; differentiable) -> dict in `splat.py`'s layout, plus `means2D`,
    the projected centre (its gradient is 3DGS's densify signal)."""
    H, W = cam["height"], cam["width"]
    ty_n, tx_n = (H + splat.TILE - 1) // splat.TILE, (W + splat.TILE - 1) // splat.TILE
    xyz = p["xyz"]
    P = xyz.shape[0]
    R = splat.quat_to_rotmat(p["rotation"])
    s = torch.exp(p["scaling"])
    opacity = torch.sigmoid(p["opacity"][:, 0])
    refl = torch.sigmoid(p["refl"][:, 0])
    M = R * s[:, None, :]
    cov3 = matmul(M, M.transpose(1, 2), prec)

    Rwv, t = cam["world_view"][:3, :3], cam["world_view"][:3, 3]
    p_view = matmul(xyz, Rwv.T, prec) + t
    z = p_view[:, 2]
    fx, fy = cam["K"][0, 0], cam["K"][1, 1]
    tan_x, tan_y = W / (2 * fx), H / (2 * fy)
    tx = torch.clamp(p_view[:, 0] / z, -1.3 * tan_x, 1.3 * tan_x) * z
    ty = torch.clamp(p_view[:, 1] / z, -1.3 * tan_y, 1.3 * tan_y) * z
    zero = torch.zeros_like(z)
    J = torch.stack([torch.stack([fx / z, zero, -fx * tx / (z * z)], -1),
                     torch.stack([zero, fy / z, -fy * ty / (z * z)], -1)], 1)  # [P, 2, 3]
    T = matmul(J, Rwv, prec)
    cov2 = matmul(matmul(T, cov3, prec), T.transpose(1, 2), prec)
    cov2 = cov2 + DILATION * torch.eye(2, device=xyz.device)
    det = cov2[:, 0, 0] * cov2[:, 1, 1] - cov2[:, 0, 1] * cov2[:, 1, 0]

    hp = matmul(torch.cat([xyz, torch.ones_like(z)[:, None]], 1), cam["full_proj"].T, prec)
    ndc = hp[:, :2] / (hp[:, 3:4] + 1e-7)
    wh = torch.tensor([float(W), float(H)], device=xyz.device)
    means2D = ((ndc + 1.0) * wh - 1.0) * 0.5

    with torch.no_grad():
        mid = 0.5 * (cov2[:, 0, 0] + cov2[:, 1, 1])
        lam = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
        r = torch.ceil(3.0 * torch.sqrt(lam))
        c = means2D
        x0 = torch.clamp(torch.floor((c[:, 0] - r) / splat.TILE), 0, tx_n).long()
        y0 = torch.clamp(torch.floor((c[:, 1] - r) / splat.TILE), 0, ty_n).long()
        x1 = torch.clamp(torch.floor((c[:, 0] + r + splat.TILE - 1) / splat.TILE), 0, tx_n).long()
        y1 = torch.clamp(torch.floor((c[:, 1] + r + splat.TILE - 1) / splat.TILE), 0, ty_n).long()
        valid = (z > splat.NEAR) & (det > 0) & ((x1 - x0) * (y1 - y0) > 0)
        valid &= p["alive"] if "alive" in p else True

    A = sqrtm_2x2(cov2)
    top = torch.cat([A, means2D[:, :, None]], 2)  # [P, 2, 3]
    last = torch.cat([torch.zeros((P, 1, 2), device=xyz.device),
                      torch.ones((P, 1, 1), device=xyz.device)], 2)
    hom = torch.cat([top, last], 1) * z[:, None, None]

    normal = shortest_axis_normals(R, s, xyz, cam["center"])
    dirs = xyz - cam["center"]
    dirs = dirs / torch.sqrt(torch.clamp(torch.sum(dirs * dirs, -1, keepdim=True), min=1e-16))
    color = splat.sh_color(torch.cat([p["features_dc"], p["features_rest"]], 1), dirs)
    return dict(hom=hom, xy=torch.full((P, 2), FAR_XY, device=xyz.device), opacity=opacity,
                color=color, normal=matmul(normal, Rwv.T, prec), refl=refl,
                depth=z.detach(), valid=valid, box=(x0, y0, x1, y1), tiles=(ty_n, tx_n),
                means2D=means2D)


def frame(p: dict, cam: dict, bg: torch.Tensor, prec: Precision, want_counts=False):
    """One served frame (no gradients): -> (render [H, W, 3], dict(stats,
    instances, maps))."""
    with torch.no_grad():
        pre = preprocess(p, cam, prec)
        gid, _, starts, counts = splat.bin_instances(pre, splat.Binning())
        inst = splat.surfel_rows(pre, prec)[gid]
        maps, stats = splat.rasterize(inst, starts, counts, pre["tiles"], cam["height"],
                                      cam["width"], want_counts)
        maps = maps.clone()
        maps[..., 0:3] += maps[..., 3:4] * bg
        out = splat.reflect_shade(maps, p["env_texture"], p["env_fail"], cam, prec, True)
    return out["render"], dict(stats=stats, instances=int(gid.shape[0]), maps=maps, out=out)


def loss_and_grads(p: dict, cam: dict, gt: torch.Tensor, bg: torch.Tensor, frame: int,
                   opt: dict, prec: Precision, fault: str = ""):
    """One step's objective and the gradient of every leaf of `p`, and of
    the projected centres (`means2D`). `fault="half_batch"` takes the
    image-space means over the top half of the rows only (a planted
    fault). -> (loss, {leaf: gradient})."""
    gauss = {k: p[k].detach().requires_grad_(True) for k in GAUSSIAN_LEAVES}
    rest = {k: p[k].detach().requires_grad_(True) for k in LEAVES if k not in gauss}
    with torch.enable_grad():
        pre = preprocess({**gauss, "alive": p["alive"]}, cam, prec)
        rows = splat.surfel_rows(pre, prec)
    gid, _, starts, counts = splat.bin_instances(pre, splat.Binning())
    inst = rows.detach()[gid]
    H, W = cam["height"], cam["width"]
    maps, _ = splat.rasterize(inst, starts, counts, pre["tiles"], H, W)
    maps = maps.clone().requires_grad_(True)
    with torch.enable_grad():
        m = torch.cat([maps[..., 0:3] + maps[..., 3:4] * bg, maps[..., 3:]], -1)
        out = splat.reflect_shade(m, rest["env_texture"], rest["env_fail"], cam, prec, True)
        rgb = ref_train.apply_isp(rest, out["render"], frame, prec)
        target = gt
        if fault == "half_batch":
            rgb, target = rgb[: H // 2], gt[: H // 2]
        l1 = torch.mean(torch.abs(rgb - target))
        loss = (1.0 - opt["lambda_dssim"]) * l1 + opt["lambda_dssim"] * (
            1.0 - ref_train.ssim(rgb, target, prec))
        nerr = 1.0 - torch.sum(out["normal"] * out["surf_normal"], -1)
        if fault == "half_batch":
            nerr = nerr[: H // 2]
        loss = loss + opt["lambda_normal"] * torch.mean(nerr) + ref_train.isp_regularization(rest)
        names = list(rest)
        got = torch.autograd.grad(loss, [maps] + [rest[k] for k in names])
    d_inst = splat.blend_backward(inst, starts, counts, pre["tiles"], H, W, got[0])
    if prec.bf16_grads:
        d_inst = d_inst.to(torch.bfloat16).to(torch.float32)
    d_rows = torch.zeros_like(rows).index_add_(0, gid, d_inst)
    leaves = [gauss[k] for k in GAUSSIAN_LEAVES] + [pre["means2D"]]
    g_gauss = torch.autograd.grad(rows, leaves, d_rows, allow_unused=True)
    grads = {k: torch.zeros_like(x) if g is None else g
             for k, x, g in zip(GAUSSIAN_LEAVES + ("means2D",), leaves, g_gauss)}
    grads.update(zip(names, got[1:]))
    return float(loss.detach()), grads


def run_steps(p0: dict, steps: list, bg, opt: dict, extent: float, first_step: int,
              prec: Precision, fault: str = ""):
    """Follow the program's first steps from the same leaves `p0`; `steps`
    holds (camera dict, ground truth [H, W, 3], frame index) per step.
    -> dict(losses, grad_norms (per step, per leaf), params after the last
    step)."""
    p = dict(p0)
    state = dict(count=0, mu={k: torch.zeros_like(p[k]) for k in LEAVES},
                 nu={k: torch.zeros_like(p[k]) for k in LEAVES})
    losses, norms = [], []
    for i, (cam, gt, frame_idx) in enumerate(steps):
        loss, grads = loss_and_grads(p, cam, gt, bg, frame_idx, opt, prec, fault)
        losses.append(loss)
        norms.append({k: float(torch.linalg.vector_norm(grads[k].double())) for k in LEAVES})
        p = ref_train.adam(p, grads, state, ref_train.learning_rates(opt, first_step + i + 1,
                                                                     extent))
        del grads
    return dict(losses=losses, grad_norms=norms, params=p)

