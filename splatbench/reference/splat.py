"""Plain PyTorch reference of the 2DGS deferred-reflection frame.

The semantics of the reference CUDA rasterizer of 2D Gaussian surfels
(forward.cu: the splat-to-pixel homography, the 3-sigma screen box, the
ray-splat intersection with the low-pass floor, front-to-back compositing
that stops below T = 1e-4) with the deferred reflection of its
gaussian_renderer (reflect the camera ray about the rendered normal, sample
a seamless cubemap through a sigmoid, blend by the rendered reflection
strength). It is written from those equations in plain tensor operations and
differentiated by autograd; it imports nothing of the program.

Tiles: 16x16 pixels, pixel (x, y) at integer coordinates. A surfel is binned
into every tile of its screen box (the program's "rect" rule), or, with
`tight`, into the tiles of each box column that its 3-sigma conic or its
low-pass disk reaches; `opacity_rect` shrinks the box to where
opacity * exp(-rho/2) can reach 1/255. Within a tile the instances are
ordered by view depth, ties by surfel index.

`Precision` states the arithmetic the configuration prescribes, and the
lower precision of the control: `tf32` rounds every operand of a matrix
product or convolution to TF32 (10 mantissa bits), as the card's tensor
cores do with TF32 on; `bf16_content` rounds the blended content rows
(colour, normal, reflection strength) to bfloat16, and `bf16_grads` rounds
each instance's gradient row to bfloat16 before the per-surfel sum, as the
training configuration's packed instance rows do.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

TILE = 16
NEAR = 0.2
FILTER_INV_SQUARE = 2.0
FILTER_SIZE = 0.707106
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4
CUTOFF = 3.0
PAIR_BUDGET = 1 << 25  # (instance, pixel) pairs a tile batch evaluates at once

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)


@dataclasses.dataclass(frozen=True)
class Precision:
    tf32: bool = False
    bf16_content: bool = False
    bf16_grads: bool = False


@dataclasses.dataclass(frozen=True)
class Binning:
    opacity_rect: bool = False
    tight: bool = False


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 explicit mantissa bits, ties to
    even), kept in float32."""
    i = x.contiguous().view(torch.int32)
    lsb = (i >> 13) & 1
    r = (i + 0x0FFF + lsb) & ~0x1FFF
    keep = ((i >> 23) & 0xFF) == 0xFF  # inf / nan unchanged
    return torch.where(keep, i, r).view(torch.float32)


class _RoundTF32(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return tf32_round(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _RoundBF16(torch.autograd.Function):
    """Round to bfloat16 (ties to even), gradient passed through."""

    @staticmethod
    def forward(ctx, x):
        return x.to(torch.bfloat16).to(torch.float32)

    @staticmethod
    def backward(ctx, g):
        return g


def bf16(x: torch.Tensor) -> torch.Tensor:
    return _RoundBF16.apply(x)


def mm_operand(x: torch.Tensor, prec: Precision) -> torch.Tensor:
    return _RoundTF32.apply(x) if prec.tf32 else x


def matmul(a, b, prec: Precision):
    return torch.matmul(mm_operand(a, prec), mm_operand(b, prec))


# -- camera ---------------------------------------------------------------------

def camera(R, T, fovx, fovy, height, width, device, znear=0.01, zfar=100.0) -> dict:
    """Matrices of a pinhole camera (camera-to-world rotation R, world-to-view
    translation T, OpenCV axes), built in numpy float32."""
    R = np.asarray(R, np.float32)
    T = np.asarray(T, np.float32)
    wv = np.zeros((4, 4), np.float32)
    wv[:3, :3] = R.T
    wv[:3, 3] = T
    wv[3, 3] = 1.0
    proj = projection(znear, zfar, fovx, fovy)
    fx = width / (2 * math.tan(fovx / 2))
    fy = height / (2 * math.tan(fovy / 2))
    K = np.array([[fx, 0, width / 2], [0, fy, height / 2], [0, 0, 1]], np.float32)
    center = -R @ T
    return _camera_dict(wv, proj @ wv, center, K, height, width, device)


def projection(znear, zfar, fovx, fovy) -> np.ndarray:
    tan_x, tan_y = math.tan(fovx / 2), math.tan(fovy / 2)
    P = np.zeros((4, 4), np.float32)
    P[0, 0] = znear / (tan_x * znear)
    P[1, 1] = znear / (tan_y * znear)
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P


def viewer_camera(req: dict, device) -> dict:
    """The camera of a viewer request (world_view and full_proj as sent, K
    from the fov and frame size)."""
    H, W = int(req["height"]), int(req["width"])
    wv = np.asarray(req["world_view"], np.float32)
    fx = W / (2 * math.tan(req["fovx"] / 2))
    fy = H / (2 * math.tan(req["fovy"] / 2))
    K = np.array([[fx, 0, W / 2], [0, fy, H / 2], [0, 0, 1]], np.float32)
    center = np.linalg.inv(wv)[:3, 3]
    return _camera_dict(wv, np.asarray(req["full_proj"], np.float32), center, K, H, W, device)


def _camera_dict(wv, full_proj, center, K, H, W, device):
    t = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
    return dict(world_view=t(wv), full_proj=t(full_proj), center=t(center), K=t(K),
                height=int(H), width=int(W))


def camera_rays(cam, prec: Precision) -> torch.Tensor:
    """[H, W, 3] unit world directions through integer pixel coordinates."""
    H, W = cam["height"], cam["width"]
    dev = cam["K"].device
    j, i = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                          torch.arange(W, dtype=torch.float32, device=dev), indexing="ij")
    pix = torch.stack([i, j, torch.ones_like(i)], -1)
    d = matmul(pix, torch.linalg.inv(cam["K"]).T, prec)
    d = matmul(d, cam["world_view"][:3, :3], prec)  # rows @ R_w2v = R_c2w applied
    return d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)


# -- per-surfel preprocess --------------------------------------------------------

def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], -1).unflatten(-1, (3, 3))


def sh_color(sh: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """max(0.5 + sum_m c_m Y_m(dir), 0) for degree-3 coefficients [P, 16, 3]."""
    x, y, z = dirs.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, yz, xz = x * y, y * z, x * z
    basis = torch.stack([
        SH_C0 * torch.ones_like(x), -SH_C1 * y, SH_C1 * z, -SH_C1 * x,
        SH_C2[0] * xy, SH_C2[1] * yz, SH_C2[2] * (2 * zz - xx - yy), SH_C2[3] * xz,
        SH_C2[4] * (xx - yy),
        SH_C3[0] * y * (3 * xx - yy), SH_C3[1] * xy * z, SH_C3[2] * y * (4 * zz - xx - yy),
        SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy), SH_C3[4] * x * (4 * zz - xx - yy),
        SH_C3[5] * z * (xx - yy), SH_C3[6] * x * (xx - 3 * yy),
    ], -1)
    raw = torch.sum(basis[..., None] * sh, dim=-2) + 0.5
    return torch.maximum(raw, torch.zeros_like(raw))


def _conic_box(hom, cut_sq):
    """Center and half extent of the screen box of {rho3d <= cut_sq} of a
    homography (rows Tu, Tv, Tw), and whether the conic is proper."""
    Tu, Tv, Tw = hom[:, 0], hom[:, 1], hom[:, 2]
    t = torch.stack([cut_sq, cut_sq, -torch.ones_like(cut_sq)], -1)
    d = torch.sum(t * Tw * Tw, -1)
    ok = d != 0
    f = t / torch.where(ok, d, torch.ones_like(d))[:, None]
    center = torch.stack([torch.sum(f * Tu * Tw, -1), torch.sum(f * Tv * Tw, -1)], -1)
    s = torch.stack([torch.sum(f * Tu * Tu, -1), torch.sum(f * Tv * Tv, -1)], -1)
    h0 = center * center - s
    return center, torch.sqrt(torch.clamp(h0, min=1e-4)), ok, h0, d


def preprocess(p: dict, cam: dict, prec: Precision, binning: Binning):
    """Per-surfel screen quantities of the raw leaves `p` (xyz, features_dc,
    features_rest, scaling, rotation, opacity, refl; differentiable) ->
    dict of [P, ...] tensors."""
    H, W = cam["height"], cam["width"]
    ty_n, tx_n = (H + TILE - 1) // TILE, (W + TILE - 1) // TILE
    xyz = p["xyz"]
    P = xyz.shape[0]
    R = quat_to_rotmat(p["rotation"])
    s = torch.exp(p["scaling"])
    opacity = torch.sigmoid(p["opacity"][:, 0])
    refl = torch.sigmoid(p["refl"][:, 0])
    zeros, ones = torch.zeros_like(s[:, :1]), torch.ones_like(s[:, :1])
    s2w = torch.stack([torch.cat([R[:, :, 0] * s[:, 0:1], zeros], -1),
                       torch.cat([R[:, :, 1] * s[:, 1:2], zeros], -1),
                       torch.cat([xyz, ones], -1)], -1)  # [P, 4, 3]
    ndc2pix = torch.tensor([[W / 2.0, 0, 0, (W - 1) / 2.0], [0, H / 2.0, 0, (H - 1) / 2.0],
                            [0, 0, 0, 1.0]], dtype=torch.float32, device=xyz.device)
    A = matmul(ndc2pix, cam["full_proj"], prec)
    hom = matmul(A, s2w, prec)  # [P, 3, 3]: hom @ (u, v, 1) = (x w, y w, w)
    Rwv = cam["world_view"][:3, :3]
    p_view = matmul(xyz, Rwv.T, prec) + cam["world_view"][:3, 3]
    n_view = matmul(R[:, :, 2], Rwv.T, prec)
    cosv = -torch.sum(p_view * n_view, -1)
    n_view = torch.sign(cosv).detach()[:, None] * n_view

    with torch.no_grad():
        cut = torch.full((P,), CUTOFF * CUTOFF, device=xyz.device)
        center, ext, box_ok, _, _ = _conic_box(hom.detach(), cut)
        low = CUTOFF * FILTER_SIZE
        rxy = torch.ceil(torch.clamp(ext, min=low))
        lo, hi = center - rxy, center + rxy
        keep = torch.ones((P,), dtype=torch.bool, device=xyz.device)
        if binning.opacity_rect:
            op = opacity.detach()
            rho_cut = torch.clamp(2.0 * torch.log(torch.clamp(255.0 * op, min=1e-12)), 0.0, 9.0)
            keep = 255.0 * op >= 1.0
            cc, ce, _, h0c, dc = _conic_box(hom.detach(), rho_cut)
            good = ((dc < 0) & (h0c[:, 0] > 1e-4) & (h0c[:, 1] > 1e-4))[:, None]
            half = torch.ceil(torch.maximum(torch.abs(cc - center) + ce,
                                            torch.sqrt(rho_cut)[:, None] * FILTER_SIZE) + 1.0)
            lo = torch.where(good, torch.maximum(lo, center - half), lo)
            hi = torch.where(good, torch.minimum(hi, center + half), hi)
        x0 = torch.clamp(torch.floor(lo[:, 0] / TILE), 0, tx_n).long()
        y0 = torch.clamp(torch.floor(lo[:, 1] / TILE), 0, ty_n).long()
        x1 = torch.clamp(torch.floor((hi[:, 0] + TILE - 1) / TILE), 0, tx_n).long()
        y1 = torch.clamp(torch.floor((hi[:, 1] + TILE - 1) / TILE), 0, ty_n).long()
        area = (x1 - x0) * (y1 - y0)
        valid = (p_view[:, 2] > NEAR) & (cosv != 0) & box_ok & (area > 0) & keep
        valid &= p["alive"] if "alive" in p else True

    # the low-pass center is the 3-sigma box center, differentiable in hom
    Tu, Tv, Tw = hom[:, 0], hom[:, 1], hom[:, 2]
    t9 = torch.tensor([9.0, 9.0, -1.0], device=xyz.device)
    dd = torch.sum(t9 * Tw * Tw, -1)
    f = t9 / torch.where(dd != 0, dd, torch.ones_like(dd))[:, None]
    xy = torch.stack([torch.sum(f * Tu * Tw, -1), torch.sum(f * Tv * Tw, -1)], -1)

    dirs = xyz - cam["center"]
    dirs = dirs / torch.sqrt(torch.clamp(torch.sum(dirs * dirs, -1, keepdim=True), min=1e-16))
    sh = torch.cat([p["features_dc"], p["features_rest"]], 1)
    color = sh_color(sh, dirs)
    return dict(hom=hom, xy=xy, opacity=opacity, color=color, normal=n_view, refl=refl,
                depth=p_view[:, 2].detach(), valid=valid, box=(x0, y0, x1, y1),
                tiles=(ty_n, tx_n))


# -- binning ---------------------------------------------------------------------

def _tight_keep(pre, gid, tx, ty):
    """Whether each (surfel, tile) of the box lies in the tile-row range of
    its column that the 3-sigma conic {rho3d <= 9} or the low-pass disk about
    the box center reaches."""
    hom = pre["hom"].detach()[gid].double()
    Tu, Tv, Tw = hom[:, 0], hom[:, 1], hom[:, 2]
    A, B, C = torch.cross(Tv, Tw, dim=-1), torch.cross(Tw, Tu, dim=-1), torch.cross(Tu, Tv, dim=-1)
    n = torch.clamp(torch.stack([A, B, C], 1).abs().amax((1, 2)), min=1e-30)[:, None]
    A, B, C = A / n, B / n, C / n
    q2 = lambda u, v: u[:, 0] * v[:, 0] + u[:, 1] * v[:, 1] - 9.0 * u[:, 2] * v[:, 2]
    qa, qb, qc = q2(A, A), q2(B, B), 2 * q2(A, B)
    qd, qe, qf = 2 * q2(A, C), 2 * q2(B, C), q2(C, C)
    det = 4 * qa * qb - qc * qc
    ok = (qa > 1e-12) & (qb > 1e-12) & (det > 1e-12)
    sdet = torch.where(ok, det, torch.ones_like(det))
    xc = (qc * qe - 2 * qb * qd) / sdet
    yc = (qc * qd - 2 * qa * qe) / sdet
    Rr = -(qf + 0.5 * (qd * xc + qe * yc))
    ok = ok & (Rr > 0)
    sqb = torch.where(ok, qb, torch.ones_like(qb))
    al = torch.where(ok, -qc / (2 * sqb), torch.zeros_like(qb))
    ga = torch.where(ok, Rr / sqb, torch.zeros_like(qb))
    de = torch.clamp(torch.where(ok, det / (4 * sqb * sqb), torch.ones_like(qb)), min=1e-20)
    # a degenerate conic keeps the whole box column
    x0 = tx.double() * TILE
    u0, u1 = x0 - xc, x0 + (TILE - 1) - xc
    umax = torch.sqrt(torch.clamp(ga / de, min=0))
    u0c, u1c = torch.maximum(u0, -umax), torch.minimum(u1, umax)
    on = (u0c <= u1c) & (ga > 0)
    ut = torch.sign(al) * torch.sqrt(torch.clamp(al * al * ga / (de * (de + al * al)), min=0))
    V = lambda u: al * u + torch.sqrt(torch.clamp(ga - de * u * u, min=0))
    y_hi = yc + V(torch.minimum(torch.maximum(ut, u0c), u1c))
    y_lo = yc - V(torch.minimum(torch.maximum(ut, -u1c), -u0c))
    px, py = pre["xy"].detach()[gid, 0].double(), pre["xy"].detach()[gid, 1].double()
    rl = CUTOFF * FILTER_SIZE
    disk = (x0 + TILE - 1 - px >= -rl) & (x0 - px <= rl)
    big = 3.4e38
    hi = torch.maximum(torch.where(on, y_hi, -big), torch.where(disk, py + rl, -big))
    lo = torch.minimum(torch.where(on, y_lo, big), torch.where(disk, py - rl, big))
    r0 = torch.floor(lo / TILE)
    r1 = torch.floor(hi / TILE) + 1
    inside = (ty.double() >= r0) & (ty.double() < r1) & (on | disk)
    return torch.where(ok, inside, torch.ones_like(inside))


def bin_instances(pre, binning: Binning):
    """(surfel id, tile id) of every instance, sorted by tile, then view
    depth, then surfel id; and the per-tile [start, count)."""
    x0, y0, x1, y1 = pre["box"]
    ty_n, tx_n = pre["tiles"]
    valid = pre["valid"]
    area = torch.where(valid, (x1 - x0) * (y1 - y0), torch.zeros_like(x0))
    gid = torch.repeat_interleave(torch.arange(area.shape[0], device=area.device), area)
    first = torch.cumsum(area, 0) - area
    j = torch.arange(gid.shape[0], device=area.device) - first[gid]
    w = (x1 - x0)[gid]
    tx = x0[gid] + j % w
    ty = y0[gid] + j // w
    if binning.tight:
        keep = torch.cat([_tight_keep(pre, gid[k:k + (1 << 22)], tx[k:k + (1 << 22)],
                                      ty[k:k + (1 << 22)])
                          for k in range(0, gid.shape[0], 1 << 22)]) if gid.numel() else \
            torch.zeros(0, dtype=torch.bool, device=area.device)
        gid, tx, ty = gid[keep], tx[keep], ty[keep]
    tile = ty * tx_n + tx
    depth_rank = torch.empty_like(area)
    order = torch.sort(pre["depth"], stable=True).indices
    depth_rank[order] = torch.arange(order.shape[0], device=area.device)
    key = tile * area.shape[0] + depth_rank[gid]
    perm = torch.sort(key).indices
    gid, tile = gid[perm], tile[perm]
    counts = torch.bincount(tile, minlength=ty_n * tx_n)
    starts = torch.cumsum(counts, 0) - counts
    return gid, tile, starts, counts


# -- the blend ----------------------------------------------------------------------

def surfel_rows(pre, prec: Precision) -> torch.Tensor:
    """[P, 19]: homography rows (9), FILTER_INV_SQUARE * low-pass center
    (2), log opacity, then the blended content: colour 3, normal 3,
    reflection strength."""
    P = pre["hom"].shape[0]
    content = torch.cat([pre["color"], pre["normal"], pre["refl"][:, None]], 1)
    if prec.bf16_content:
        content = bf16(content)
    lo = torch.log(torch.clamp(pre["opacity"], min=1e-12))
    return torch.cat([pre["hom"].reshape(P, 9), FILTER_INV_SQUARE * pre["xy"], lo[:, None],
                      content], 1)


def _cross(a, b):
    return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2], a[0] * b[1] - a[1] * b[0])


def blend_tiles(rows, valid, org_x, org_y, want_counts=False):
    """Composite B tiles of K instances each: rows [B, K, 19] in depth order,
    valid [B, K], tile origins [B]. -> maps [B, 256, 9] (colour 3, T, depth,
    normal 3, reflection), and with `want_counts` the per-pixel
    (alpha tests up to termination, last contributor rank, contributors)."""
    dev = rows.device
    lane = torch.arange(TILE * TILE, device=dev)
    px = (lane % TILE - 7).double()
    py = (lane // TILE - 7).double()
    cx = (org_x + 7).double()[:, None]
    cy = (org_y + 7).double()[:, None]
    g = rows.double()
    Tu = (g[..., 0], g[..., 1], g[..., 2])
    Tv = (g[..., 3], g[..., 4], g[..., 5])
    Tw = (g[..., 6], g[..., 7], g[..., 8])
    # p(x, y) = (x Tw - Tu) x (y Tw - Tv) = x A + y B + C on the tile-centred
    # basis; coefficients in float64, rounded once to float32
    Av, Bv, Cv = _cross(Tv, Tw), _cross(Tw, Tu), _cross(Tu, Tv)
    Cc = [Cv[k] + cx * Av[k] + cy * Bv[k] for k in range(3)]
    dot = lambda a: a[0] * Tw[0] + a[1] * Tw[1] + a[2] * Tw[2]
    da, db = dot(Av), dot(Bv)
    dc = dot(Cv) + cx * da + cy * db
    ex = g[..., 9] / FILTER_INV_SQUARE - cx  # low-pass center, tile-centred
    ey = g[..., 10] / FILTER_INV_SQUARE - cy
    lo = g[..., 11]
    f32 = lambda t: t.float()[..., None]
    pxf, pyf = px.float(), py.float()
    field = lambda a, b, c: f32(a) * pxf + f32(b) * pyf + f32(c)
    p0 = field(Av[0], Bv[0], Cc[0])
    p1 = field(Av[1], Bv[1], Cc[1])
    p2 = field(Av[2], Bv[2], Cc[2])
    dn = field(da, db, dc)
    unstable = torch.abs(p2) < 1e-4
    inv = 1.0 / torch.where(unstable, torch.ones_like(p2), p2)
    rho3 = (p0 * p0 + p1 * p1) * inv * inv
    dx = pxf - f32(ex)
    dy = pyf - f32(ey)
    rho2 = FILTER_INV_SQUARE * (dx * dx + dy * dy)
    rho = torch.where(unstable, rho2, torch.minimum(rho3, rho2))
    alpha = torch.exp(torch.clamp(f32(lo) - 0.5 * rho, max=math.log(ALPHA_MAX)))
    # where the low-pass floor sets alpha, the depth's gradient reaches Tw
    # with the intersection (u, v) held fixed (the reference backward.cu)
    tw = rows[..., 6:9, None]
    u_, v_ = (p0 * inv).detach(), (p1 * inv).detach()
    frozen = u_ * tw[..., 0, :] + v_ * tw[..., 1, :] + tw[..., 2, :]
    d_full = dn * inv
    lowpass = ~unstable & (rho2 < rho3)
    depth = torch.where(unstable, tw[..., 2, :].expand_as(p2),
                        torch.where(lowpass, d_full.detach() + frozen - frozen.detach(), d_full))
    accept = (depth >= NEAR) & (alpha >= ALPHA_MIN) & valid[..., None]
    a = torch.where(accept, alpha, torch.zeros_like(alpha))
    u = torch.log1p(-a)
    logT = torch.cumsum(u, 1) - u  # exclusive, along the instances
    T_before = torch.exp(logT)
    contrib = accept & (T_before * (1.0 - a) >= T_EPS)
    w = torch.where(contrib, a * T_before, torch.zeros_like(a))
    T_final = torch.exp(torch.sum(torch.where(contrib, u, torch.zeros_like(u)), 1))
    con = rows[..., 12:19]  # colour 3, normal 3, refl
    acc = torch.einsum("bkl,bkc->blc", w, con)
    dep = torch.sum(w * depth, 1)
    maps = torch.cat([acc[..., 0:3], T_final[..., None], dep[..., None], acc[..., 3:7]], -1)
    if not want_counts:
        return maps
    with torch.no_grad():
        rank = torch.arange(1, rows.shape[1] + 1, device=dev)[None, :, None]
        done = accept & (T_before * (1.0 - a) < T_EPS)
        first_done = torch.where(done, rank, torch.full_like(rank, 1 << 30)).amin(1)
        n_valid = valid.sum(1)[:, None]
        tested = torch.minimum(first_done, n_valid)
        last = torch.where(contrib, rank, torch.zeros_like(rank)).amax(1)
        n_con = contrib.sum(1)
        # alpha tests the backward makes: up to the pixel's last contributor
        return maps, (tested, last, n_con)


def tile_batches(counts, budget=PAIR_BUDGET):
    """Tiles grouped into batches of similar instance counts, each with at
    most `budget` (instance, pixel) pairs. -> list of tile-index tensors."""
    order = torch.sort(counts, descending=True).indices
    c = counts[order].tolist()
    out, i = [], 0
    n = len(c)
    while i < n and c[i] > 0:
        k = max(1, budget // (c[i] * TILE * TILE))
        out.append(order[i:i + k])
        i += k
    return out


def gather_batch(inst_rows, starts, counts, tiles):
    K = int(counts[tiles].max())
    slot = torch.arange(K, device=inst_rows.device)
    idx = starts[tiles][:, None] + slot
    valid = slot[None] < counts[tiles][:, None]
    idx = torch.where(valid, idx, torch.zeros_like(idx))
    return idx, valid


def tiles_to_image(x, tiles, ty_n, tx_n, out):
    """Scatter [B, 256, C] tile pixels into the image-shaped buffer `out`
    [ty_n*16, tx_n*16, C]."""
    B, _, C = x.shape
    ty, tx = tiles // tx_n, tiles % tx_n
    v = out.view(ty_n, TILE, tx_n, TILE, C)
    v[ty, :, tx, :] = x.view(B, TILE, TILE, C)


def image_to_tiles(img, tiles, ty_n, tx_n):
    C = img.shape[-1]
    v = img.view(ty_n, TILE, tx_n, TILE, C)
    ty, tx = tiles // tx_n, tiles % tx_n
    return v[ty, :, tx, :].reshape(tiles.shape[0], TILE * TILE, C)


def rasterize(inst_rows, starts, counts, tiles_hw, H, W, want_counts=False):
    """Blend every tile (no autograd). -> maps [H, W, 9] with T = 1 where no
    instance reached, and with `want_counts` per-tile count tensors."""
    ty_n, tx_n = tiles_hw
    dev = inst_rows.device
    full = torch.zeros((ty_n * TILE, tx_n * TILE, 9), device=dev)
    full[..., 3] = 1.0
    stats = []
    with torch.no_grad():
        for tiles in tile_batches(counts):
            idx, valid = gather_batch(inst_rows, starts, counts, tiles)
            org_x, org_y = (tiles % tx_n) * TILE, (tiles // tx_n) * TILE
            res = blend_tiles(inst_rows[idx], valid, org_x, org_y, want_counts)
            if want_counts:
                res, st = res
                stats.append((tiles, counts[tiles]) + st)
            tiles_to_image(res, tiles, ty_n, tx_n, full)
    return full[:H, :W], stats


def blend_backward(inst_rows, starts, counts, tiles_hw, H, W, d_maps) -> torch.Tensor:
    """d loss / d inst_rows, given d loss / d maps [H, W, 9], by autograd of
    the blend one tile batch at a time."""
    ty_n, tx_n = tiles_hw
    pad = torch.zeros((ty_n * TILE, tx_n * TILE, 9), device=d_maps.device)
    pad[:H, :W] = d_maps
    d_rows = torch.zeros_like(inst_rows)
    for tiles in tile_batches(counts, PAIR_BUDGET // 2):
        idx, valid = gather_batch(inst_rows, starts, counts, tiles)
        org_x, org_y = (tiles % tx_n) * TILE, (tiles // tx_n) * TILE
        rb = inst_rows[idx].detach().requires_grad_(True)
        with torch.enable_grad():
            maps = blend_tiles(rb, valid, org_x, org_y)
            (g,) = torch.autograd.grad(maps, rb, image_to_tiles(pad, tiles, ty_n, tx_n))
        d_rows[idx[valid]] = g[valid]
    return d_rows


# -- cubemap ----------------------------------------------------------------------

# seamless cubemap edges (LEFT_TOP_AS_ORIGIN): for each face and side
# (left, right, top, bottom) the neighbouring face and the affine map of
# (x, y) to its texel, (ax, ay, c) * (x, y, L-1) per output axis
_EDGE_FACE = [[4, 5, 3, 2], [5, 4, 3, 2], [1, 0, 4, 5], [1, 0, 4, 5], [1, 0, 3, 2], [0, 1, 3, 2]]
_EDGE_X = [
    [(0, 0, 1), (0, 0, 0), (0, 0, 1), (0, 0, 1)],
    [(0, 0, 1), (0, 0, 0), (0, 0, 0), (0, 0, 0)],
    [(0, -1, 1), (0, 1, 0), (1, 0, 0), (-1, 0, 1)],
    [(0, -1, 1), (0, 1, 0), (1, 0, 0), (-1, 0, 1)],
    [(0, 0, 1), (0, 0, 0), (1, 0, 0), (1, 0, 0)],
    [(0, 0, 1), (0, 0, 0), (-1, 0, 1), (-1, 0, 1)],
]
_EDGE_Y = [
    [(0, 1, 0), (0, 1, 0), (1, 0, 0), (1, 0, 0)],
    [(0, 1, 0), (0, 1, 0), (-1, 0, 1), (-1, 0, 1)],
    [(0, 0, 1), (0, 0, 1), (0, 0, 1), (0, 0, 1)],
    [(0, 0, 0), (0, 0, 0), (0, 0, 0), (0, 0, 0)],
    [(0, 1, 0), (0, 1, 0), (0, 0, 0), (0, 0, 0)],
    [(0, 1, 0), (0, 1, 0), (0, 0, 1), (0, 0, 1)],
]


def _padded_index(L: int):
    """For the faces padded by one texel on each side: [6*(L+2)^2, 3] source
    texel rows of [6*L*L] and [.., 3] weights (a border texel copies its
    neighbour face's texel, a corner averages three)."""
    Lp = L + 2
    src = np.zeros((6, Lp, Lp, 3), np.int64)
    wt = np.zeros((6, Lp, Lp, 3), np.float32)
    flat = lambda f, x, y: (f * L + y) * L + x

    def edge(f, side, x, y):
        fx, fy = _EDGE_X[f][side], _EDGE_Y[f][side]
        nx = fx[0] * x + fx[1] * y + fx[2] * (L - 1)
        ny = fy[0] * x + fy[1] * y + fy[2] * (L - 1)
        return flat(_EDGE_FACE[f][side], nx, ny)

    for f in range(6):
        for y in range(L):
            for x in range(L):
                src[f, y + 1, x + 1, 0], wt[f, y + 1, x + 1, 0] = flat(f, x, y), 1.0
        for i in range(L):
            src[f, i + 1, 0, 0], wt[f, i + 1, 0, 0] = edge(f, 0, 0, i), 1.0
            src[f, i + 1, Lp - 1, 0], wt[f, i + 1, Lp - 1, 0] = edge(f, 1, L - 1, i), 1.0
            src[f, 0, i + 1, 0], wt[f, 0, i + 1, 0] = edge(f, 2, i, 0), 1.0
            src[f, Lp - 1, i + 1, 0], wt[f, Lp - 1, i + 1, 0] = edge(f, 3, i, L - 1), 1.0
        for (cy, cx), (iy, ix), (s1, a1, b1), (s2, a2, b2) in (
            ((0, 0), (0, 0), (0, 0, 0), (2, 0, 0)),
            ((0, Lp - 1), (0, L - 1), (1, L - 1, 0), (2, L - 1, 0)),
            ((Lp - 1, 0), (L - 1, 0), (0, 0, L - 1), (3, 0, L - 1)),
            ((Lp - 1, Lp - 1), (L - 1, L - 1), (1, L - 1, L - 1), (3, L - 1, L - 1)),
        ):
            src[f, cy, cx] = (flat(f, ix, iy), edge(f, s1, a1, b1), edge(f, s2, a2, b2))
            wt[f, cy, cx] = 1.0 / 3.0
    return src.reshape(-1, 3), wt.reshape(-1, 3)


_PAD_CACHE: dict = {}


def sample_cubemap(texture, fail, dirs):
    """Seamless bilinear sample of a cubemap [6, C, L, L] along dirs [..., 3]
    (differentiable in texture and directions); zero directions read
    `fail`."""
    L = texture.shape[-1]
    C = texture.shape[1]
    key = (L, str(texture.device))
    if key not in _PAD_CACHE:
        s, w = _padded_index(L)
        _PAD_CACHE[key] = (torch.tensor(s, device=texture.device),
                           torch.tensor(w, device=texture.device))
    src, wt = _PAD_CACHE[key]
    tex = texture.permute(0, 2, 3, 1).reshape(-1, C)
    padded = torch.sum(tex[src] * wt[..., None], 1)  # [6*Lp*Lp, C]
    Lp = L + 2
    x, y, z = dirs.unbind(-1)
    ax, ay, az = x.abs(), y.abs(), z.abs()
    dim = torch.where(az > torch.maximum(ax, ay), 2, (ay > ax).long())
    face = torch.where(dim == 0, torch.where(x >= 0, 0, 1),
                       torch.where(dim == 1, torch.where(y >= 0, 2, 3),
                                   torch.where(z >= 0, 4, 5)))
    den = torch.where(dim == 0, x, torch.where(dim == 1, y, z))
    den = torch.where(den == 0, torch.ones_like(den), den)
    un = torch.where(dim == 0, -z, torch.where(face == 3, -x, x))
    vn = torch.stack([-y, y, z, -z, -y, y], -1).gather(-1, face[..., None])[..., 0]
    su = (un / den * 0.5 + 0.5) * L
    sv = (-(vn / den) * 0.5 + 0.5) * L
    x0 = torch.floor(su - 0.5)
    y0 = torch.floor(sv - 0.5)
    kx, ky = su - x0 - 0.5, sv - y0 - 0.5
    xp = torch.clamp(x0.long() + 1, 0, Lp - 2)
    yp = torch.clamp(y0.long() + 1, 0, Lp - 2)
    row = lambda yy, xx: padded[(face * Lp + yy) * Lp + xx]
    out = ((1 - ky)[..., None] * ((1 - kx)[..., None] * row(yp, xp) + kx[..., None] * row(yp, xp + 1))
           + ky[..., None] * ((1 - kx)[..., None] * row(yp + 1, xp) + kx[..., None] * row(yp + 1, xp + 1)))
    zero = torch.all(dirs == 0, -1)
    return torch.where(zero[..., None], fail, out)


# -- the frame --------------------------------------------------------------------

def safe_normalize(v, eps=1e-6):
    n2 = torch.sum(v * v, -1, keepdim=True)
    return v / (torch.sqrt(torch.clamp(n2, min=eps * eps)) + eps)


def reflect_shade(maps, texture, fail, cam, prec: Precision, with_surface: bool):
    """Image-space part of a frame from the blended maps [H, W, 9]
    (colour 3, T, depth, view normal 3, reflection): -> dict with `render`
    (deferred reflection over the base colour), `normal`, `alpha` and, with
    `with_surface`, `surf_normal` (the depth-derived normal times alpha)."""
    color, T, dep, nv, rs = maps[..., 0:3], maps[..., 3:4], maps[..., 4:5], maps[..., 5:8], \
        maps[..., 8:9]
    alpha = 1.0 - T
    Rwv = cam["world_view"][:3, :3]
    normal = safe_normalize(matmul(nv, Rwv, prec))  # view -> world: rows @ R_w2v
    rays = camera_rays(cam, prec)
    rd = rays - 2.0 * normal * torch.sum(rays * normal, -1, keepdim=True)
    env = torch.sigmoid(sample_cubemap(texture, fail, rd))
    out = dict(render=(1.0 - rs) * color + rs * env, normal=normal, alpha=alpha)
    if with_surface:
        depth = torch.nan_to_num(dep / torch.maximum(alpha, torch.full_like(alpha, 1e-3)), nan=0.0)
        H, W = cam["height"], cam["width"]
        j, i = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=maps.device),
                              torch.arange(W, dtype=torch.float32, device=maps.device),
                              indexing="ij")
        pix = torch.stack([i, j, torch.ones_like(i)], -1)
        d = matmul(matmul(pix, torch.linalg.inv(cam["K"]).T, prec), Rwv, prec)
        pts = depth * d + cam["center"]
        dx = pts[2:, 1:-1] - pts[:-2, 1:-1]
        dy = pts[1:-1, 2:] - pts[1:-1, :-2]
        n = safe_normalize(torch.linalg.cross(dx, dy, dim=-1), eps=1e-12)
        out["surf_normal"] = torch.nn.functional.pad(n, (0, 0, 1, 1, 1, 1)) * alpha.detach()
    return out


def frame(p: dict, cam: dict, bg: torch.Tensor, prec: Precision, binning: Binning,
          want_counts=False):
    """One served frame (no gradients): -> (render [H, W, 3], stats)."""
    with torch.no_grad():
        pre = preprocess(p, cam, prec, binning)
        gid, _, starts, counts = bin_instances(pre, binning)
        inst = surfel_rows(pre, prec)[gid]
        maps, stats = rasterize(inst, starts, counts, pre["tiles"], cam["height"],
                                cam["width"], want_counts)
        maps = maps.clone()
        maps[..., 0:3] += maps[..., 3:4] * bg
        out = reflect_shade(maps, p["env_texture"], p["env_fail"], cam, prec, False)
    return out["render"], dict(stats=stats, instances=int(gid.shape[0]))


def encode_u8(img: torch.Tensor) -> torch.Tensor:
    return (torch.clamp(img, 0, 1) * 255.0 + 0.5).to(torch.uint8)
