"""Learned cubemap environment map.

Port of tpu_splat/envmap/cubemap.py: dominant-axis face selection, the
LEFT_TOP_AS_ORIGIN EdgeTable, the seamless filter baked into EdgeTable-padded
faces, and the quad-texture gather. Texture layout [6, C, L, L] (face,
channel, y, x), as the reference checkpoint format. The forward is a row
gather, as in the JAX package. The seamless sample is differentiable in
texture, fail value and direction: its texel gradient goes through the
`cubemap_tap_accumulate` kernel (kernels/cubemap_accum.py), its direction
gradient through the tap-weight derivatives. The "bilinear" and "nearest"
filters differentiate by autograd of their gathers. `resize_cubemap` and
`sharpen_cubemap` serve the trainer's env-map doubling and filtering.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tpu_splat_torch.core.device import resolve_device
from tpu_splat_torch.core.transforms import inverse_sigmoid


class CubemapParams(NamedTuple):
    texture: torch.Tensor  # [6, C, L, L]
    fail_value: torch.Tensor  # [C]

    @property
    def resolution(self) -> int:
        return self.texture.shape[-1]

    @property
    def channels(self) -> int:
        return self.texture.shape[1]


def init_cubemap(
    generator: torch.Generator | None,
    channels: int = 3,
    resolution: int = 128,
    device: str | torch.device = "cuda",
) -> CubemapParams:
    """U(-0.5, 0.5) texture init, zero fail value (cubemap_encoder.py:93-96).
    Draws come from `generator` (a CPU torch.Generator) and are then moved,
    so a seed gives the same texture on every device."""
    dev = resolve_device(device)
    tex = torch.rand(
        (6, channels, resolution, resolution), generator=generator
    ) - 0.5
    return CubemapParams(
        texture=tex.to(dev), fail_value=torch.zeros((channels,), device=dev)
    )


# EdgeTable (LEFT_TOP_AS_ORIGIN, cubemapencoder.cu:66-106) as affine maps:
# out = ax*x + ay*y + c*(L-1), per (face, flag in {1,2,4,8}).
# flag: 1 = u < 0.5 (left), 2 = u >= L-0.5 (right), 4 = v < 0.5, 8 = v >= L-0.5
_EDGE_FACE = np.array(
    [
        [4, 5, 3, 2],
        [5, 4, 3, 2],
        [1, 0, 4, 5],
        [1, 0, 4, 5],
        [1, 0, 3, 2],
        [0, 1, 3, 2],
    ],
    dtype=np.int32,
)
# (ax, ay, c) for output x
_EDGE_X = np.array(
    [
        [(0, 0, 1), (0, 0, 0), (0, 0, 1), (0, 0, 1)],
        [(0, 0, 1), (0, 0, 0), (0, 0, 0), (0, 0, 0)],
        [(0, -1, 1), (0, 1, 0), (1, 0, 0), (-1, 0, 1)],
        [(0, -1, 1), (0, 1, 0), (1, 0, 0), (-1, 0, 1)],
        [(0, 0, 1), (0, 0, 0), (1, 0, 0), (1, 0, 0)],
        [(0, 0, 1), (0, 0, 0), (-1, 0, 1), (-1, 0, 1)],
    ],
    dtype=np.int32,
)
# (ax, ay, c) for output y
_EDGE_Y = np.array(
    [
        [(0, 1, 0), (0, 1, 0), (1, 0, 0), (1, 0, 0)],
        [(0, 1, 0), (0, 1, 0), (-1, 0, 1), (-1, 0, 1)],
        [(0, 0, 1), (0, 0, 1), (0, 0, 1), (0, 0, 1)],
        [(0, 0, 0), (0, 0, 0), (0, 0, 0), (0, 0, 0)],
        [(0, 1, 0), (0, 1, 0), (0, 0, 0), (0, 0, 0)],
        [(0, 1, 0), (0, 1, 0), (0, 0, 1), (0, 0, 1)],
    ],
    dtype=np.int32,
)


def _edge_remap(face, x, y, flag_idx, L):
    """Vectorized EdgeTable on numpy index arrays: (face, x, y) + flag index
    -> remapped (face, x, y)."""
    f = _EDGE_FACE[face, flag_idx]
    cx = _EDGE_X[face, flag_idx]
    cy = _EDGE_Y[face, flag_idx]
    nx = cx[..., 0] * x + cx[..., 1] * y + cx[..., 2] * (L - 1)
    ny = cy[..., 0] * x + cy[..., 1] * y + cy[..., 2] * (L - 1)
    return f, nx, ny


def _face_uv(dirs: torch.Tensor):
    """Dominant-axis face selection + per-face UV (cubemapencoder.cu:147-187).
    dirs [..., 3] -> (face int32, u, v) with u, v in [-1, 1]."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    ax_, ay_, az_ = x.abs(), y.abs(), z.abs()
    dim1 = (ay_ > ax_).to(torch.int32)
    maxv1 = torch.maximum(ax_, ay_)
    dim = torch.where(az_ > maxv1, torch.full_like(dim1, 2), dim1)

    i32 = lambda v: torch.full_like(dim, v)
    face = torch.where(
        dim == 0,
        torch.where(x >= 0, i32(0), i32(1)),
        torch.where(
            dim == 1,
            torch.where(y >= 0, i32(2), i32(3)),
            torch.where(z >= 0, i32(4), i32(5)),
        ),
    )
    # one division by the dominant component; per-face numerators fold in
    # the sign flips:
    #   f0: u=-z/x v=-y/x | f1: u=-z/x v= y/x | f2: u= x/y v= z/y
    #   f3: u=-x/y v=-z/y | f4: u= x/z v=-y/z | f5: u= x/z v= y/z
    denom = torch.where(dim == 0, x, torch.where(dim == 1, y, z))
    denom = torch.where(denom == 0.0, torch.ones_like(denom), denom)
    u_num = torch.where(dim == 0, -z, torch.where(face == 3, -x, x))
    v_num = torch.where(
        face == 0,
        -y,
        torch.where(
            face == 1,
            y,
            torch.where(
                face == 2, z, torch.where(face == 3, -z, torch.where(face == 4, -y, y))
            ),
        ),
    )
    return face, u_num / denom, v_num / denom


def _w4_terms(kx, ky, vert):
    """Bilinear tap weights (and their kx/ky derivatives), with the corner
    case's 3-texel average folded in (cubemapencoder.cu:235-240)."""
    a, b = 1.0 - kx, 1.0 - ky
    t = vert / 3.0
    w4 = torch.stack([
        b * a + t * (ky * kx),
        b * kx + t * (ky * kx),
        ky * a + t * (ky * kx),
        (1.0 - vert) * ky * kx,
    ])
    wx4 = torch.stack([
        -b + t * ky,
        b + t * ky,
        -ky + t * ky,
        (1.0 - vert) * ky,
    ])
    wy4 = torch.stack([
        -a + t * kx,
        -kx + t * kx,
        a + t * kx,
        (1.0 - vert) * kx,
    ])
    return w4, wx4, wy4


def _sample4_quad_impl(tex_flat, kx, ky, vert, sep_i, derivs: bool = True):
    """Quad-texture forward gather (`_sample4_impl(quad=True)`): the four
    bilinear taps are the 2x2 block at (x0, y0) of the padded face, read as
    one row of an overlapping-2x2 re-layout of the texture. Returns the
    sample and its kx / ky derivative blends (gx, gy; None unless derivs)."""
    w4, wx4, wy4 = _w4_terms(kx, ky, vert)
    M, C = tex_flat.shape
    L2 = int(round((M / 6) ** 0.5))
    assert 6 * L2 * L2 == M
    tex2 = tex_flat.reshape(6, L2, L2, C)
    quad_t = torch.cat(
        [tex2[:, :-1, :-1], tex2[:, :-1, 1:], tex2[:, 1:, :-1], tex2[:, 1:, 1:]],
        dim=-1,
    ).reshape(6 * (L2 - 1) * (L2 - 1), 4 * C)
    r0, xp0 = sep_i[0], sep_i[2]
    f = torch.div(r0, L2, rounding_mode="floor")
    y0 = r0 - f * L2
    v4 = quad_t[((f * (L2 - 1) + y0) * (L2 - 1) + xp0).long()]  # [..., 4C]
    taps = [v4[..., t * C : (t + 1) * C] for t in range(4)]
    blend = lambda wt: sum(wt[t][..., None] * taps[t] for t in range(4))
    if not derivs:
        return blend(w4), None, None
    return blend(w4), blend(wx4), blend(wy4)


def _tileorder(shape):
    """Flattener: [..., H, W] image order -> 16x32 tile-major [..., H*W], so
    that face-edge pixels (smooth curves in reflection maps) cluster into few
    blocks and a warp's taps stay close. The tap accumulation does not depend
    on the order, so no inverse is needed."""
    if len(shape) == 2 and shape[0] % 16 == 0 and shape[1] % 32 == 0:
        H, W = shape
        ty, tx = H // 16, W // 32

        def flat(a):
            a = a.reshape(a.shape[:-2] + (ty, 16, tx, 32)).transpose(-3, -2)
            return a.reshape(a.shape[:-4] + (H * W,))

        return flat
    n = 1
    for d in shape:
        n *= d
    return lambda a: a.reshape(a.shape[: a.dim() - len(shape)] + (n,))


class _Sample4Quad(torch.autograd.Function):
    """The seamless 4-tap sample (the JAX `_sample4_quad` custom VJP). The
    forward also yields gx / gy; the backward gives the direction gradients
    through d_kx = gx . g and d_ky = gy . g, and the texel gradient through
    `cubemap_tap_accumulate` (every pixel separable on the padded faces)."""

    @staticmethod
    def forward(ctx, tex_flat, kx, ky, vert, sep_i, sep_m):
        # gx / gy only when a direction gradient is wanted (not in serving)
        derivs = ctx.needs_input_grad[1] or ctx.needs_input_grad[2]
        out, gx, gy = _sample4_quad_impl(tex_flat, kx, ky, vert, sep_i, derivs)
        ctx.save_for_backward(gx, gy, kx, ky, sep_i, sep_m)
        ctx.n_texels = tex_flat.shape[0]
        return out

    @staticmethod
    def backward(ctx, g):
        from tpu_splat_torch.core.device import stage
        from tpu_splat_torch.kernels.cubemap_accum import cubemap_tap_accumulate

        gx, gy, kx, ky, sep_i, sep_m = ctx.saved_tensors
        C = g.shape[-1]
        d_kx = None if gx is None else torch.sum(gx * g, dim=-1)
        d_ky = None if gy is None else torch.sum(gy * g, dim=-1)
        L = int(round((ctx.n_texels / 6) ** 0.5))
        flat = _tileorder(tuple(kx.shape))
        i32 = lambda a: flat(a).to(torch.int32).contiguous()
        r0, r1, c0, c1 = (i32(sep_i[k]) for k in range(4))
        sm = flat(sep_m).contiguous()
        with stage("cubemap_accumulate"):
            d_tex = cubemap_tap_accumulate(
                flat(g.movedim(-1, 0)).movedim(0, -1).contiguous(),
                None, None, None,  # no generic taps: every pixel is separable
                r0, r1, c0, c1, flat(ky).contiguous(), flat(kx).contiguous(), sm,
                L=L, C=C,
            )
        return d_tex, d_kx, d_ky, None, None, None


def _pad_faces(texture: torch.Tensor) -> torch.Tensor:
    """[6, C, L, L] -> [6, C, L+2, L+2]: each 1-texel border is filled from
    the adjacent face through the EdgeTable, and each corner pad is the mean
    of its 3 valid neighbours. Plain bilinear on the padded face is then
    exactly the reference's seamless filter (see the JAX `_pad_faces`)."""
    L = texture.shape[-1]
    y_idx = np.arange(L, dtype=np.int32)
    # flag column in _EDGE_*: 0=left(u<0.5), 1=right, 2=top(v<0.5), 3=bottom
    specs = {
        0: (np.zeros(L, np.int32), y_idx),
        1: (np.full(L, L - 1, np.int32), y_idx),
        2: (y_idx, np.zeros(L, np.int32)),
        3: (y_idx, np.full(L, L - 1, np.int32)),
    }
    pads = []
    for f in range(6):
        face_pads = {}
        for flag, (xs, ys) in specs.items():
            nf, nx, ny = (
                torch.as_tensor(a, dtype=torch.long, device=texture.device)
                for a in _edge_remap(
                    np.full(L, f, np.int32), xs, ys, np.full(L, flag, np.int32), L
                )
            )
            face_pads[flag] = texture[nf, :, ny, nx]  # [L, C]
        pads.append(face_pads)

    Lp = L + 2
    P = torch.zeros(
        texture.shape[:2] + (Lp, Lp), dtype=texture.dtype, device=texture.device
    )
    P[:, :, 1:-1, 1:-1] = texture
    for f in range(6):
        P[f, :, 1:-1, 0] = pads[f][0].T  # left column
        P[f, :, 1:-1, Lp - 1] = pads[f][1].T
        P[f, :, 0, 1:-1] = pads[f][2].T  # top row
        P[f, :, Lp - 1, 1:-1] = pads[f][3].T
        for (cy, cx), (iy, ix), (e1, i1), (e2, i2) in (
            ((0, 0), (0, 0), (0, 0), (2, 0)),
            ((0, Lp - 1), (0, L - 1), (1, 0), (2, L - 1)),
            ((Lp - 1, 0), (L - 1, 0), (0, L - 1), (3, 0)),
            ((Lp - 1, Lp - 1), (L - 1, L - 1), (1, L - 1), (3, L - 1)),
        ):
            P[f, :, cy, cx] = (
                texture[f, :, iy, ix] + pads[f][e1][i1] + pads[f][e2][i2]
            ) / 3.0
    return P


def _tex_flat(texture: torch.Tensor) -> torch.Tensor:
    """[6, C, L, L] -> [6*L*L, C] texel rows."""
    return texture.permute(0, 2, 3, 1).reshape(-1, texture.shape[1])


def sample_cubemap(
    params: CubemapParams, dirs: torch.Tensor, interp: str = "seamless"
) -> torch.Tensor:
    """dirs [..., 3] -> colours [..., C]; zero directions return the fail
    value. interp: "seamless" (the production filter), "bilinear" (clamped
    at face edges) or "nearest"."""
    L = params.resolution
    fail = torch.all(dirs == 0.0, dim=-1)
    face, u, v = _face_uv(dirs)
    v = -v  # LEFT_TOP_AS_ORIGIN (cubemapencoder.cu:202-204)
    su = (u * 0.5 + 0.5) * L
    sv = (v * 0.5 + 0.5) * L

    if interp == "nearest":
        iy = torch.clamp(sv.to(torch.int32), 0, L - 1)
        ix = torch.clamp(su.to(torch.int32), 0, L - 1)
        out = _tex_flat(params.texture)[((face * L + iy) * L + ix).long()]
    else:
        x0f = torch.floor(su - 0.5)
        y0f = torch.floor(sv - 0.5)
        kx = su - x0f - 0.5
        ky = sv - y0f - 0.5
        x0i = x0f.to(torch.int32)
        y0i = y0f.to(torch.int32)
        if interp == "bilinear":
            x0 = torch.clamp(x0i, 0, L - 1)
            x1 = torch.clamp(x0i + 1, 0, L - 1)
            y0 = torch.clamp(y0i, 0, L - 1)
            y1 = torch.clamp(y0i + 1, 0, L - 1)
            flat = lambda x, y: ((face * L + y) * L + x).long()
            idx4 = torch.stack([flat(x0, y0), flat(x1, y0), flat(x0, y1), flat(x1, y1)])
            w4, _, _ = _w4_terms(kx, ky, torch.zeros_like(su))
            vals = _tex_flat(params.texture)[idx4]  # [4, ..., C]
            out = torch.sum(w4[..., None] * vals, dim=0)
        elif interp == "seamless":
            # seamless filtering as data: plain bilinear on the EdgeTable-
            # padded faces (see _pad_faces)
            Lp = L + 2
            padded = _pad_faces(params.texture)
            xp0 = torch.clamp(x0i + 1, 0, Lp - 2)
            yp0 = torch.clamp(y0i + 1, 0, Lp - 2)
            sep_i = torch.stack([face * Lp + yp0, face * Lp + yp0 + 1, xp0, xp0 + 1])
            out = _Sample4Quad.apply(
                _tex_flat(padded), kx, ky, torch.zeros_like(su), sep_i,
                torch.ones_like(su),
            )
        else:
            raise ValueError(f"unknown interp {interp!r}")

    return torch.where(fail[..., None], params.fail_value, out)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """The Keys cubic kernel (a = -0.5) as jax.image evaluates it."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _cubic_resize_matrix(n_in: int, n_out: int, device) -> torch.Tensor:
    """[n_in, n_out] float32 weights of jax.image.resize(method="cubic")
    along one axis: half-pixel centres, the kernel scaled when shrinking,
    its weights normalised over the taps that fall inside the input, and
    samples outside the input zeroed (jax/_src/image/scale.py:
    compute_weight_mat). torch's bicubic interpolate (a = -0.75, edge
    clamping) is another function."""
    inv_scale = 1.0 / torch.tensor(n_out / n_in, dtype=torch.float32)
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample_f = (torch.arange(n_out, dtype=torch.float32) + 0.5) * inv_scale - 0.5
    x = torch.abs(sample_f[None, :] - torch.arange(n_in, dtype=torch.float32)[:, None])
    weights = _keys_cubic(x / kernel_scale)
    total = weights.sum(0, keepdim=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    weights = torch.where(total.abs() > eps,
                          weights / torch.where(total != 0, total, torch.ones_like(total)),
                          torch.zeros_like(weights))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return torch.where(inside[None, :], weights, torch.zeros_like(weights)).to(device)


def resize_cubemap(params: CubemapParams, new_resolution: int) -> CubemapParams:
    """Bicubic resize of every face (reference resize(),
    cubemap_encoder.py:102-105; used by double_env_map): the JAX package's
    jax.image.resize(method="cubic"), applied as one weight matrix per
    axis."""
    L = params.resolution
    w = _cubic_resize_matrix(L, new_resolution, params.texture.device)
    tex = torch.einsum("fcij,iy,jx->fcyx", params.texture, w, w)
    return CubemapParams(texture=tex.contiguous(), fail_value=params.fail_value)


def sharpen_cubemap(params: CubemapParams, factor: float = 2.0) -> CubemapParams:
    """Sharpen in sigmoid space (reference filter(), cubemap_encoder.py:
    107-113: torchvision adjust_sharpness, the 1-pixel border kept, then
    clamped to [1e-3, 1 - 1e-3] before the logit). The 3x3 blur
    [[1, 1, 1], [1, 5, 1], [1, 1, 1]] / 13 is summed out explicitly, in
    full float32 on every device."""
    img = torch.sigmoid(params.texture)  # [6, C, L, L]
    L = img.shape[-1]
    pad = torch.nn.functional.pad(img, (1, 1, 1, 1))
    k = torch.tensor([[1.0, 1.0, 1.0], [1.0, 5.0, 1.0], [1.0, 1.0, 1.0]]) / 13.0
    blurred = sum(float(k[dy, dx]) * pad[..., dy:dy + L, dx:dx + L]
                  for dy in range(3) for dx in range(3))
    sharp = torch.clamp(factor * img + (1 - factor) * blurred, 0.0, 1.0)
    out = img.clone()
    out[..., 1:-1, 1:-1] = sharp[..., 1:-1, 1:-1]
    out = torch.clamp(out, 1e-3, 1 - 1e-3)
    return CubemapParams(texture=inverse_sigmoid(out), fail_value=params.fail_value)
