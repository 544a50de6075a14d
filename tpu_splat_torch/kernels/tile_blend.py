"""Per-tile alpha compositing of surfels: the tile-blend kernel pair.

Port of tpu_splat/kernels/tile_blend.py. Instances ship
RAW per-Gaussian attributes (homography rows Tu/Tv/Tw, low-pass center,
log-opacity, content) in a feature-major [F, N_cap] slab whose per-tile
ranges are 128-aligned and exclusive. Per instance the kernel derives the
coefficients of the ray-splat intersection p = x*(Tv x Tw) + y*(Tw x Tu) +
(Tu x Tv) on a tile-recentered pixel basis, then composites front to back.

Transmittance follows the JAX kernel's chunk semantics: within a chunk of
CI=128 instances T_before = T_carry * exp(sum of log1p(-a) over earlier
accepted instances) and contrib = accept & (T_after >= 1e-4); at the chunk
end T_carry picks up the contributors' log sum, and a pixel is done once
T_carry * exp(sum over all accepted) < 1e-4.

The backward re-walks each tile back to front, rebuilds T by dividing the
alphas back out in log space, and writes per-instance gradients of the raw
attribute rows (hand-derived, as the JAX kernel; not autograd of the
forward). `blend_kernel` is the pair as one autograd Function, and
`pack_features` regroups the per-instance gradients per Gaussian.

`tile_blend_forward` / `tile_blend_backward` run the CUDA kernels
(csrc/tile_blend_fwd.cu, csrc/tile_blend_bwd.cu) on CUDA tensors and the
plain PyTorch versions beside them on CPU tensors.
"""
from __future__ import annotations

import ctypes
import math

import torch

from tpu_splat_torch.core import f32
from tpu_splat_torch.kernels import LAUNCHES
from tpu_splat_torch.raster.config import (
    TILE,
    TILE_PIX,
    NEAR_N,
    FAR_N,
    ALPHA_MIN,
    ALPHA_MAX,
    T_EPS,
    FILTER_INV_SQUARE,
)

# feature rows of the [F, N] instance slab
F_TU = 0  # 0:3  homography row Tu
F_TV = 3  # 3:6  homography row Tv
F_TW = 6  # 6:9  homography row Tw
F_AX2 = 9  # FILTER_INV_SQUARE * xy.x (low-pass screen ellipse center)
F_AY2 = 10  # FILTER_INV_SQUARE * xy.y
F_LO = 11  # log(opacity)
F_CON = 12  # 12:20 content: color 3, normal 3, refl, scope
N_CON = 8
F_GRAD = 19  # gradient rows 0:19 can be nonzero (scope + pads never)
F_PAD = 24
F_IN_PACKED = 16  # packed slab: content pairs (c[k], c[k+4]) in rows 12..15

LOG_AMAX = math.log(ALPHA_MAX)
M_C1 = FAR_N / (FAR_N - NEAR_N)
M_C2 = M_C1 * NEAR_N

# per-pixel output rows of out_px [T, 16, 256]
O_COL = 0  # 0:3
O_T = 3
O_DEPTH = 4
O_REFL = 5
O_DIST = 6
O_NRM = 7  # 7:10
O_MED = 10
O_SCOPE = 11
O_NCON = 12
O_M1 = 13
O_M2 = 14
O_MEDRANK = 15  # median contributor rank (1-based, 0 = none)

CI = 128  # instances per chunk
L = TILE_PIX
PLAIN_TILE_BATCH = 256  # tiles per step of the plain version ([B,CI,L] temps)


# ---------------------------------------------------------------------------
# bf16 pair packing (bit-exact with the JAX package's)


def _pack2_bits(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16-round two f32 tensors (round to nearest even) and pack
    (a = high 16 bits | b = low 16 bits) into one f32-bitcast word."""
    ia = a.to(torch.bfloat16).to(torch.float32).view(torch.int32)
    ib = b.to(torch.bfloat16).to(torch.float32).view(torch.int32)
    lo = (ib >> 16) & 0xFFFF
    return ((ia & -65536) | lo).view(torch.float32)


def _unpack2_bits(p: torch.Tensor):
    """Inverse of _pack2_bits -> (hi, lo) f32 (exact bf16 values)."""
    u = p.view(torch.int32)
    hi = (u & -65536).view(torch.float32)
    lo = torch.bitwise_left_shift(u, 16).view(torch.float32)
    return hi, lo


def _pack_g16(g24: torch.Tensor) -> torch.Tensor:
    """[P, F_PAD] -> [P, 16]: geometry rows verbatim, content rows 12..15 as
    bf16 pairs (content[k], content[k+4])."""
    con = g24[:, F_CON : F_CON + 8]
    pairs = [_pack2_bits(con[:, k].contiguous(), con[:, k + 4].contiguous()) for k in range(4)]
    return torch.cat([g24[:, :12], torch.stack(pairs, dim=1)], dim=1)


def _content_rows(fb: torch.Tensor, packed: bool) -> torch.Tensor:
    """[8, ...] content rows (c0,c1,c2,n0,n1,n2,refl,scope) of a slab."""
    if not packed:
        return fb[F_CON : F_CON + N_CON]
    hi, lo = _unpack2_bits(fb[12:16].contiguous())
    return torch.cat([hi, lo], dim=0)


def pack_features(
    sorted_gid: torch.Tensor,  # [N_cap] (pad slots may hold any id; masked)
    valid: torch.Tensor,  # [N_cap] bool
    hom: torch.Tensor,  # [P,3,3]
    xy: torch.Tensor,  # [P,2]
    opacity: torch.Tensor,  # [P]
    normal_view: torch.Tensor,  # [P,3]
    color: torch.Tensor,  # [P,3]
    refl: torch.Tensor,  # [P]
    scope_mask: torch.Tensor,  # [P] bool
    group_key: torch.Tensor | None = None,  # [N_cap] the binning's aligned_rank
    rank_of: torch.Tensor | None = None,
    seg_start: torch.Tensor | None = None,
    seg_end: torch.Tensor | None = None,
    bf16_grads: bool = False,
    bf16_feats: bool = False,
) -> torch.Tensor:
    """Gather per-Gaussian raw attributes into the kernel's feature-major
    [F_PAD | 16, N_cap] slab: one masked row gather. Given the binning's
    per-Gaussian grouping (group_key/rank_of/seg_*), the gather's gradient
    is the sort-regroup plus segment sum of `regroup_grads` (bf16_grads
    packs its payload rows in bf16 pairs)."""
    P_ = opacity.shape[0]
    # a device fill, not a host copy (which would synchronize the stream)
    lo = f32.log(torch.maximum(opacity, opacity.new_full((), 1e-12)))
    g24 = torch.cat(
        [
            hom.reshape(P_, 9),
            FILTER_INV_SQUARE * xy,
            lo[:, None],
            color,
            normal_view,
            refl[:, None],
            scope_mask.to(torch.float32)[:, None],
            torch.zeros((P_, F_PAD - 20), dtype=torch.float32, device=hom.device),
        ],
        dim=1,
    )
    if group_key is not None:
        return _ExpandRows.apply(g24, sorted_gid, valid, group_key, rank_of,
                                 seg_start, seg_end, bf16_grads, bf16_feats)
    g_in = _pack_g16(g24) if bf16_feats else g24
    feats = torch.where(valid[:, None], g_in[sorted_gid.long()], 0.0)
    return feats.T.contiguous()


# ---------------------------------------------------------------------------
# the plain PyTorch version


def _pixel_basis(device, dtype=torch.float32):
    lane = torch.arange(L, device=device)
    pixx = (lane % TILE - 7).to(dtype)
    pixy = (lane // TILE - 7).to(dtype)
    return pixx, pixy, pixx * pixx + pixy * pixy


def _cross(a, b):
    a0, a1, a2 = a
    b0, b1, b2 = b
    return (a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0)


def _dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _excl_cumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Exclusive prefix sum along `dim` (sequential order)."""
    c = torch.cumsum(x.narrow(dim, 0, x.shape[dim] - 1), dim)
    return torch.cat([torch.zeros_like(x.narrow(dim, 0, 1)), c], dim)


def _instance_coeffs(fb, cxf, cyf):
    """Per-instance coefficients on the tile-recentered basis (the JAX
    `_geom_rows`): p = x*A + y*B + C' with A = Tv x Tw, B = Tw x Tu, C' the
    recentered Tu x Tv; depth numerator p.Tw; low-pass exponent s2 = s0 +
    sx x + sy y - FI/2 r^2. Evaluated in float64 and rounded once, as the
    kernel does: the cross products cancel, and a float32 evaluation puts
    the blend farther from the JAX reference than its tests allow."""
    dt = fb.dtype
    fi = FILTER_INV_SQUARE
    g = fb[:F_CON].double()
    cx, cy = cxf.double(), cyf.double()
    Tu = (g[F_TU], g[F_TU + 1], g[F_TU + 2])
    Tv = (g[F_TV], g[F_TV + 1], g[F_TV + 2])
    Tw = (g[F_TW], g[F_TW + 1], g[F_TW + 2])
    A = _cross(Tv, Tw)
    Bc = _cross(Tw, Tu)
    C = _cross(Tu, Tv)
    cp = [C[k] + cx * A[k] + cy * Bc[k] for k in range(3)]
    da, db, dc = _dot3(A, Tw), _dot3(Bc, Tw), _dot3(C, Tw)
    dcc = dc + cx * da + cy * db
    lo = g[F_LO]
    sx = g[F_AX2] - fi * cx
    sy = g[F_AY2] - fi * cy
    s0 = lo - (sx * sx + sy * sy) * (0.5 / fi)
    f = lambda x: x.to(dt)
    return (tuple(map(f, A)), tuple(map(f, Bc)), tuple(map(f, cp)),
            f(da), f(db), f(dcc), f(sx), f(sy), f(s0), f(lo))


def _cross_products(fb):
    """(Tu, Tv, Tw, A, B, C) of a slab's instances as float32 rows, with
    A = Tv x Tw, B = Tw x Tu, C = Tu x Tv derived in float64 (as
    _instance_coeffs) -- the rows the backward's cross-product VJPs use."""
    g = fb[:F_CON].double()
    Tu = (g[F_TU], g[F_TU + 1], g[F_TU + 2])
    Tv = (g[F_TV], g[F_TV + 1], g[F_TV + 2])
    Tw = (g[F_TW], g[F_TW + 1], g[F_TW + 2])
    f = lambda v: tuple(x.to(fb.dtype) for x in v)
    return f(Tu), f(Tv), f(Tw), f(_cross(Tv, Tw)), f(_cross(Tw, Tu)), f(_cross(Tu, Tv))


def _blend_tiles_plain(feats, start, count, org_x, org_y, train_shape,
                       packed_feats, collect_wmax, wmax):
    """Blend B tiles at once ([B, CI, L] per chunk). Writes wmax in place for
    this batch's slots and returns (out_px [B, 16, L], pairs): pairs counts
    the (instance, pixel) alpha tests the kernel makes on these tiles, i.e.
    those of valid slots at pixels not yet done."""
    dev, dt = feats.device, feats.dtype
    n_cap = feats.shape[1]
    B = start.shape[0]
    fi = FILTER_INV_SQUARE
    px, py, r2 = _pixel_basis(dev, dt)
    cxf = (org_x + 7).to(dt)[:, None]  # [B, 1]
    cyf = (org_y + 7).to(dt)[:, None]
    ci_ar = torch.arange(CI, device=dev)
    zl = lambda: torch.zeros((B, L), dtype=dt, device=dev)
    T_c = torch.ones((B, L), dtype=dt, device=dev)
    done = torch.zeros((B, L), dtype=torch.bool, device=dev)
    dep, ncon, m1, m2, dist, med, medrank = (zl() for _ in range(7))
    con = torch.zeros((B, N_CON, L), dtype=dt, device=dev)
    pairs = torch.zeros((), dtype=torch.int64, device=dev)

    n_chunks = int((int(count.max()) + CI - 1) // CI) if B else 0
    for ci in range(n_chunks):
        slot = ci * CI + ci_ar  # [CI] rank - 1 within the tile
        idx = start[:, None].long() + slot  # [B, CI]
        valid = slot[None, :] < count[:, None]
        fb = feats[:, torch.clamp(idx, 0, n_cap - 1)]  # [F, B, CI]
        fb = torch.where(valid[None], fb, 0.0)
        pairs += (valid.sum(1) * (~done).sum(1)).sum()

        A, Bc, cp, da, db, dcc, sx, sy, s0, lo = _instance_coeffs(fb, cxf, cyf)

        def field(xc, yc, cc):  # [B, CI] coefficients -> [B, CI, L]
            return xc[..., None] * px + yc[..., None] * py + cc[..., None]

        p0 = field(A[0], Bc[0], cp[0])
        p1 = field(A[1], Bc[1], cp[1])
        p2 = field(A[2], Bc[2], cp[2])
        dn = field(da, db, dcc)
        s2 = field(sx, sy, s0) - (0.5 * fi) * r2
        unstable = torch.abs(p2) < 1e-4
        ivp = 1.0 / torch.where(unstable, 1.0, p2)
        ivp2 = ivp * ivp
        r3h = 0.5 * (p0 * p0 + p1 * p1) * ivp2
        s3 = torch.where(unstable, -1e8, lo[..., None] - r3h)
        s = torch.maximum(s3, s2)
        alpha = torch.exp(torch.clamp(s, max=LOG_AMAX))
        depth = torch.where(unstable, fb[F_TW + 2][..., None].expand_as(p2), dn * ivp)
        del p0, p1, p2, dn, s2, ivp, ivp2, r3h, s3, s

        accept = (
            (depth >= NEAR_N) & (alpha >= ALPHA_MIN) & valid[..., None] & ~done[:, None]
        )
        a_eff = torch.where(accept, alpha, 0.0)
        u = torch.log1p(-a_eff)
        T_before = T_c[:, None] * torch.exp(_excl_cumsum(u, 1))
        T_after = T_before * (1.0 - a_eff)
        contrib = accept & (T_after >= T_EPS)
        w = torch.where(contrib, alpha * T_before, 0.0)
        u_con = torch.where(contrib, u, 0.0)

        if not train_shape:
            # depth distortion (2DGS appendix; forward.cu:419-427)
            m = M_C1 - M_C2 * (1.0 / torch.clamp(depth, min=NEAR_N))
            mw = m * w
            m2w = m * mw
            M1c = m1[:, None] + _excl_cumsum(mw, 1)
            M2c = m2[:, None] + _excl_cumsum(m2w, 1)
            dterm = (m * m * (1.0 - T_before) + M2c - 2.0 * m * M1c) * w

        T_all = T_c * torch.exp(u.sum(1))
        T_new = T_c * torch.exp(u_con.sum(1))
        done = done | (T_all < T_EPS)
        dep = dep + (w * depth).sum(1)
        if not train_shape:
            m1 = m1 + mw.sum(1)
            m2 = m2 + m2w.sum(1)
            dist = dist + dterm.sum(1)
        con = con + torch.einsum("kbi,bil->bkl", _content_rows(fb, packed_feats), w)

        rank = (slot + 1).to(dt)[None, :, None]  # 1-based
        if not train_shape:
            med_cond = contrib & (T_before > 0.5)
            med_rank = torch.where(med_cond, rank, 0.0).amax(1)
            has_med = med_rank > 0.0
            sel = med_cond & (rank == med_rank[:, None])
            med_depth_new = torch.where(sel, depth, 0.0).sum(1)
            med = torch.where(has_med, med_depth_new, med)
            medrank = torch.where(has_med, med_rank, medrank)
        ncon = torch.maximum(ncon, torch.where(contrib, rank, 0.0).amax(1))
        T_c = T_new

        if collect_wmax:
            wm = torch.where(valid[..., None], w, 0.0).amax(2)  # [B, CI]
            wmax[idx[valid]] = wm[valid]
        if bool(done.all()):
            break

    scope = (con[:, 7] > 0.0).to(dt)
    out = torch.stack(
        [
            con[:, 0], con[:, 1], con[:, 2], T_c, dep, con[:, 6], dist,
            con[:, 3], con[:, 4], con[:, 5], med, scope, ncon, m1, m2, medrank,
        ],
        dim=1,
    )
    return out, pairs


def tile_blend_forward_plain(
    feats, starts, counts, org_x, org_y,
    train_shape: bool = False, packed_feats: bool = False,
    collect_wmax: bool = True,
    return_pairs: bool = False,
):
    """The plain PyTorch version of `tile_blend_forward`, on any device.
    Tiles are independent, so they run in batches of PLAIN_TILE_BATCH,
    ordered by count so a batch's chunk loop wastes little. return_pairs
    adds the number of (instance, pixel) alpha tests the kernel makes on
    these inputs (early termination included), the work its bound counts."""
    T = starts.shape[0]
    dev = feats.device
    out_px = torch.zeros((T, 16, L), dtype=feats.dtype, device=dev)
    wmax = torch.zeros((feats.shape[1],), dtype=feats.dtype, device=dev)
    pairs = torch.zeros((), dtype=torch.int64, device=dev)
    order = torch.argsort(counts.long(), descending=True, stable=True)
    for b0 in range(0, T, PLAIN_TILE_BATCH):
        sel = order[b0 : b0 + PLAIN_TILE_BATCH]
        out_px[sel], n = _blend_tiles_plain(
            feats, starts[sel], counts[sel], org_x[sel], org_y[sel],
            train_shape, packed_feats, collect_wmax, wmax,
        )
        pairs += n
    if return_pairs:
        return out_px, wmax, int(pairs)
    return out_px, wmax


# ---------------------------------------------------------------------------
# the kernel wrapper


def _check_inputs(feats, starts, counts, org_x, org_y, packed_feats):
    f_in = F_IN_PACKED if packed_feats else F_PAD
    if feats.dtype != torch.float32 or feats.dim() != 2 or feats.shape[0] != f_in:
        raise ValueError(
            f"feats must be float32 [{f_in}, N_cap], got {feats.dtype} {tuple(feats.shape)}"
        )
    T = starts.shape[0]
    for name, x in (("starts", starts), ("counts", counts), ("org_x", org_x), ("org_y", org_y)):
        if x.dtype != torch.int32 or x.shape != (T,):
            raise ValueError(f"{name} must be int32 [{T}], got {x.dtype} {tuple(x.shape)}")
        if x.device != feats.device:
            raise ValueError(f"{name} is on {x.device}, feats on {feats.device}")


def tile_blend_forward(
    feats: torch.Tensor,  # [F_PAD | 16, N_cap] feature-major instance attrs
    starts: torch.Tensor,  # [T] int32 CI-aligned exclusive range starts
    counts: torch.Tensor,  # [T] int32
    org_x: torch.Tensor,  # [T] int32 tile pixel origin
    org_y: torch.Tensor,  # [T] int32
    train_shape: bool = False,
    packed_feats: bool = False,
    collect_wmax: bool = True,
):
    """-> (out_px [T, 16, 256], wmax [N_cap]). train_shape drops the
    distortion/M1/M2/median channels (rows written as zeros); packed_feats
    reads the 16-row bf16-content slab; collect_wmax=False leaves wmax all
    zero. CPU tensors take the plain version; CUDA tensors launch the
    kernel (or raise)."""
    _check_inputs(feats, starts, counts, org_x, org_y, packed_feats)
    if feats.device.type == "cpu":
        return tile_blend_forward_plain(
            feats, starts, counts, org_x, org_y,
            train_shape=train_shape, packed_feats=packed_feats,
            collect_wmax=collect_wmax,
        )
    if feats.device.type != "cuda":
        raise ValueError(f"unsupported device {feats.device}")
    from tpu_splat_torch.kernels import build

    feats, starts, counts, org_x, org_y = (
        x.contiguous() for x in (feats, starts, counts, org_x, org_y)
    )
    T = starts.shape[0]
    out_px = torch.empty((T, 16, L), dtype=torch.float32, device=feats.device)
    wmax = torch.zeros((feats.shape[1],), dtype=torch.float32, device=feats.device)
    p, i = ctypes.c_void_p, ctypes.c_int
    build.launch(
        "tile_blend_fwd", "tile_blend_fwd",
        [p, ctypes.c_longlong, p, p, p, p, i, p, p, i, i, i, p],
        feats.data_ptr(), feats.shape[1], starts.data_ptr(), counts.data_ptr(),
        org_x.data_ptr(), org_y.data_ptr(), T, out_px.data_ptr(),
        wmax.data_ptr(), int(train_shape), int(packed_feats), int(collect_wmax),
        torch.cuda.current_stream(feats.device).cuda_stream,
    )
    LAUNCHES["tile_blend_forward"] += 1
    return out_px, wmax


# ---------------------------------------------------------------------------
# the backward: plain PyTorch version of the hand-derived reverse sweep


def _suffix_incl(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Inclusive suffix sum along `dim`."""
    return torch.flip(torch.cumsum(torch.flip(x, (dim,)), dim), (dim,))


def _used_chunks(fwd_px, counts):
    """[T] chunks per tile that hold a contributor of some pixel, from the
    forward's n_contrib rank (tile_blend.py:1371-1375)."""
    max_ncon = fwd_px[:, O_NCON, :].amax(1).to(torch.int32)
    n_chunks = (counts + CI - 1) // CI
    return torch.minimum((max_ncon + CI - 1) // CI, n_chunks).to(torch.int32)


def _bwd_tiles_plain(feats, start, count, used, org_x, org_y, fwd, ct,
                     full_grads, packed_feats, d_feats):
    """Reverse-sweep B tiles at once ([B, CI, L] per chunk), writing their
    used chunks' columns of d_feats. A transcription of the JAX kernel body
    (tpu_splat/kernels/tile_blend.py:_make_bwd_kernel), with the within-chunk
    suffix sums as flipped cumsums and the pixel-basis projections as sums.
    Returns the (instance, pixel) pairs the backward must test on these
    tiles (each pixel's ranks up to its n_contrib: no later pair can
    contribute), the contributing pairs among them, the work its bound
    counts, and the (instance, warp of 32 pixels) pairs holding a
    contributor, the per-instance reductions the kernel makes."""
    dev, dt = feats.device, feats.dtype
    n_cap = feats.shape[1]
    B = start.shape[0]
    fi = FILTER_INV_SQUARE
    px, py, r2 = _pixel_basis(dev, dt)
    cxf = (org_x + 7).to(dt)[:, None]  # [B, 1]
    cyf = (org_y + 7).to(dt)[:, None]
    ci_ar = torch.arange(CI, device=dev)
    T_final, ncon = fwd[:, O_T], fwd[:, O_NCON]
    ct_d = ct[:, O_DEPTH]
    ct7 = ct[:, [O_COL, O_COL + 1, O_COL + 2, O_NRM, O_NRM + 1, O_NRM + 2, O_REFL]]
    if full_grads:
        M1tot, M2tot, med_rank = fwd[:, O_M1], fwd[:, O_M2], fwd[:, O_MEDRANK]
        ct_dist, ct_med, ct_m1, ct_m2 = ct[:, O_DIST], ct[:, O_MED], ct[:, O_M1], ct[:, O_M2]
        Wsuf, MWsuf, M2Wsuf = (torch.zeros_like(T_final) for _ in range(3))
    T_rev = T_final
    Bc = ct[:, O_T] * T_final
    tested = torch.zeros((), dtype=torch.int64, device=dev)
    contributing = torch.zeros((), dtype=torch.int64, device=dev)
    warp_pairs = torch.zeros((), dtype=torch.int64, device=dev)
    n_rev = int(used.max()) if B else 0
    for ci_rev in range(n_rev):
        active = ci_rev < used  # [B]
        ci = torch.clamp(used - 1 - ci_rev, min=0)
        slot = ci[:, None] * CI + ci_ar  # [B, CI] rank - 1 within the tile
        idx = start[:, None].long() + slot
        valid = (slot < count[:, None]) & active[:, None]
        fb = feats[:, torch.clamp(idx, 0, n_cap - 1)]  # [F, B, CI]
        fb = torch.where(valid[None], fb, 0.0)

        A, Bv, cp, da, db, dcc, sx, sy, s0, lo = _instance_coeffs(fb, cxf, cyf)

        def field(xc, yc, cc):
            return xc[..., None] * px + yc[..., None] * py + cc[..., None]

        p0 = field(A[0], Bv[0], cp[0])
        p1 = field(A[1], Bv[1], cp[1])
        p2 = field(A[2], Bv[2], cp[2])
        dn = field(da, db, dcc)
        s2 = field(sx, sy, s0) - (0.5 * fi) * r2
        unstable = torch.abs(p2) < 1e-4
        ivp = 1.0 / torch.where(unstable, 1.0, p2)
        ivp2 = ivp * ivp
        r3h = 0.5 * (p0 * p0 + p1 * p1) * ivp2
        s3 = torch.where(unstable, -1e8, lo[..., None] - r3h)
        s = torch.maximum(s3, s2)
        alpha = torch.exp(torch.clamp(s, max=LOG_AMAX))
        depth = torch.where(unstable, fb[F_TW + 2][..., None].expand_as(p2), dn * ivp)

        rank = (slot + 1).to(dt)[..., None]
        contrib = ((depth >= NEAR_N) & (alpha >= ALPHA_MIN) & valid[..., None]
                   & (rank <= ncon[:, None]))
        tested += (valid[..., None] & (rank <= ncon[:, None])).sum()
        contributing += contrib.sum()
        warp_pairs += contrib.reshape(B, CI, -1, 32).any(-1).sum()
        lf = torch.where(contrib, -torch.log1p(-alpha), 0.0)
        T_i = T_rev[:, None] * torch.exp(_suffix_incl(lf, 1))
        w = torch.where(contrib, alpha * T_i, 0.0)
        con7 = _content_rows(fb, packed_feats)[:7]  # [7, B, CI]
        what = torch.einsum("kbi,bkl->bil", con7, ct7) + ct_d[:, None] * depth
        d_depth = w * ct_d[:, None]
        if full_grads:
            safe_depth = torch.maximum(depth, depth.new_full((), NEAR_N))
            m = M_C1 - M_C2 * (1.0 / safe_depth)
            mw = m * w
            m2w = m * mw
            W_gt = Wsuf[:, None] + (_suffix_incl(w, 1) - w)
            MW_gt = MWsuf[:, None] + (_suffix_incl(mw, 1) - mw)
            M2W_gt = M2Wsuf[:, None] + (_suffix_incl(m2w, 1) - m2w)
            M1_i = M1tot[:, None] - MW_gt - mw
            M2_i = M2tot[:, None] - M2W_gt - m2w
            A_i = 1.0 - T_i
            phi = m * m * A_i + M2_i - 2.0 * m * M1_i + m * m * W_gt - 2.0 * m * MW_gt
            what = what + ct_m1[:, None] * m + ct_m2[:, None] * m * m + ct_dist[:, None] * phi
            d_m_tot = (ct_m1[:, None] * w + 2.0 * m * ct_m2[:, None] * w
                       + ct_dist[:, None] * 2.0 * w * (m * A_i - M1_i + m * W_gt - MW_gt))
            dm_dd = torch.where(depth >= NEAR_N, M_C2 / (safe_depth * safe_depth), 0.0)
            is_med = contrib & (rank == med_rank[:, None])
            d_depth = d_depth + d_m_tot * dm_dd + torch.where(is_med, ct_med[:, None], 0.0)
            bterm = what * w - ct_dist[:, None] * w * m * m * T_i
        else:
            bterm = what * w

        B_i = Bc[:, None] + (_suffix_incl(bterm, 1) - bterm)
        d_alpha = torch.where(contrib, T_i * what - B_i / (1.0 - alpha), 0.0)
        # alpha = exp(min(log a_max, s)): the clamp passes no gradient at the
        # cap (PARITY.md D4); route d_s to the s3 / s2 branch
        d_s = alpha * (s < LOG_AMAX).to(dt) * d_alpha
        use3 = (s3 >= s2) & ~unstable
        d_s3 = torch.where(use3, d_s, 0.0)
        d_s2 = torch.where(use3, 0.0, d_s)
        use3_f = use3.to(dt)
        lp_f = (~unstable).to(dt) - use3_f  # stable and low-pass: s frozen
        d_p0m = -d_s3 * p0 * ivp2
        d_p1m = -d_s3 * p1 * ivp2
        d_p2m = d_s3 * 2.0 * r3h * ivp - dn * ivp2 * d_depth * use3_f
        d_dnm = d_depth * ivp * use3_f
        d_lp = d_depth * lp_f
        d_lpx = d_lp * p0 * ivp
        d_lpy = d_lp * p1 * ivp
        d_tw2_mat = torch.where(unstable, d_depth, 0.0) + d_lp

        def proj(X):  # pixel-basis projections (x, y, 1) -> [B, CI] each
            return (X * px).sum(-1), (X * py).sum(-1), X.sum(-1)

        pp = [proj(d_p0m), proj(d_p1m), proj(d_p2m)]
        pdn, ps2 = proj(d_dnm), proj(d_s2)
        d_s0 = ps2[2]
        d_sx = ps2[0] - sx * (1.0 / fi) * d_s0
        d_sy = ps2[1] - sy * (1.0 / fi) * d_s0
        d_lo = d_s3.sum(-1) + d_s0
        d_da = pdn[0] + cxf * pdn[2]
        d_db = pdn[1] + cyf * pdn[2]
        d_dc = pdn[2]
        Tu, Tv, Tw, Ag, Bg, Cg = _cross_products(fb)
        dA = tuple(pp[k][0] + cxf * pp[k][2] + d_da * Tw[k] for k in range(3))
        dB = tuple(pp[k][1] + cyf * pp[k][2] + d_db * Tw[k] for k in range(3))
        dC = tuple(pp[k][2] + d_dc * Tw[k] for k in range(3))
        extra = (d_lpx.sum(-1), d_lpy.sum(-1), d_tw2_mat.sum(-1))
        dTw_dn = tuple(d_da * Ag[k] + d_db * Bg[k] + d_dc * Cg[k] + extra[k] for k in range(3))
        # cross-product VJPs: A = Tv x Tw, B = Tw x Tu, C = Tu x Tv
        gTu = [a + b for a, b in zip(_cross(dB, Tw), _cross(Tv, dC))]
        gTv = [a + b for a, b in zip(_cross(Tw, dA), _cross(dC, Tu))]
        gTw = [a + b + c for a, b, c in zip(_cross(dA, Tv), _cross(Tu, dB), dTw_dn)]
        dcon = torch.einsum("bkl,bil->kbi", ct7, w)  # [7, B, CI]
        if packed_feats:
            con_rows = [_pack2_bits(dcon[0], dcon[4]), _pack2_bits(dcon[1], dcon[5]),
                        _pack2_bits(dcon[2], dcon[6]),
                        _pack2_bits(dcon[3], torch.zeros_like(dcon[3]))]
        else:
            con_rows = list(dcon) + [torch.zeros_like(d_lo)] * (d_feats.shape[0] - 19)
        rows = torch.stack(gTu + gTv + gTw + [d_sx, d_sy, d_lo] + con_rows)
        d_feats[:, idx[active]] = rows[:, active]

        T_rev = T_rev * torch.exp(lf.sum(1))
        Bc = Bc + bterm.sum(1)
        if full_grads:
            Wsuf, MWsuf, M2Wsuf = Wsuf + w.sum(1), MWsuf + mw.sum(1), M2Wsuf + m2w.sum(1)
    return tested, contributing, warp_pairs


def tile_blend_backward_plain(feats, starts, counts, org_x, org_y, fwd_px, ct_px,
                              full_grads: bool = True, packed_feats: bool = False,
                              return_pairs: bool = False):
    """The plain PyTorch version of `tile_blend_backward`, on any device:
    tiles in batches of PLAIN_TILE_BATCH // 2, ordered by used chunks.
    return_pairs adds the (instance, pixel) pairs the backward must test on
    these inputs (ranks up to each pixel's n_contrib), the contributing
    pairs among them and the (instance, warp) pairs holding a contributor."""
    T = starts.shape[0]
    d_feats = torch.zeros_like(feats)
    used = _used_chunks(fwd_px, counts)
    order = torch.argsort(used.long(), descending=True, stable=True)
    nb = PLAIN_TILE_BATCH // 2
    pairs = (0, 0, 0)
    for b0 in range(0, T, nb):
        sel = order[b0 : b0 + nb]
        p = _bwd_tiles_plain(feats, starts[sel], counts[sel], used[sel], org_x[sel],
                             org_y[sel], fwd_px[sel], ct_px[sel], full_grads,
                             packed_feats, d_feats)
        pairs = tuple(a + b for a, b in zip(pairs, p))
    if return_pairs:
        return (d_feats, *(int(x) for x in pairs))
    return d_feats


def tile_blend_backward(
    feats: torch.Tensor,  # [F_PAD | 16, N_cap] the forward's slab
    starts: torch.Tensor,  # [T] int32
    counts: torch.Tensor,  # [T] int32
    org_x: torch.Tensor,  # [T] int32
    org_y: torch.Tensor,  # [T] int32
    fwd_px: torch.Tensor,  # [T, 16, 256] forward outputs
    ct_px: torch.Tensor,  # [T, 16, 256] their cotangents
    full_grads: bool = True,
    packed_feats: bool = False,
) -> torch.Tensor:
    """-> d_feats [F_PAD | 16, N_cap]: per-instance gradients of the raw
    attribute rows (rows >= F_GRAD stay 0; packed: content-gradient bf16
    pairs in rows 12..15, the input slab's layout). full_grads=False is the
    train-shaped backward (no distortion / M1 / M2 / median chains). CPU
    tensors take the plain version; CUDA tensors launch the kernel (or
    raise)."""
    _check_inputs(feats, starts, counts, org_x, org_y, packed_feats)
    T = starts.shape[0]
    for name, x in (("fwd_px", fwd_px), ("ct_px", ct_px)):
        if x.dtype != torch.float32 or tuple(x.shape) != (T, 16, L):
            raise ValueError(f"{name} must be float32 [{T}, 16, {L}], got "
                             f"{x.dtype} {tuple(x.shape)}")
        if x.device != feats.device:
            raise ValueError(f"{name} is on {x.device}, feats on {feats.device}")
    if feats.device.type == "cpu":
        return tile_blend_backward_plain(feats, starts, counts, org_x, org_y, fwd_px,
                                         ct_px, full_grads=full_grads,
                                         packed_feats=packed_feats)
    if feats.device.type != "cuda":
        raise ValueError(f"unsupported device {feats.device}")
    from tpu_splat_torch.kernels import build

    feats, starts, counts, org_x, org_y, fwd_px, ct_px = (
        x.contiguous() for x in (feats, starts, counts, org_x, org_y, fwd_px, ct_px)
    )
    used = _used_chunks(fwd_px, counts)
    d_feats = torch.zeros_like(feats)
    p, i = ctypes.c_void_p, ctypes.c_int
    build.launch(
        "tile_blend_bwd", "tile_blend_bwd",
        [p, ctypes.c_longlong, p, p, p, p, p, p, p, i, p, i, i, p],
        feats.data_ptr(), feats.shape[1], starts.data_ptr(), counts.data_ptr(),
        used.data_ptr(), org_x.data_ptr(), org_y.data_ptr(), fwd_px.data_ptr(),
        ct_px.data_ptr(), T, d_feats.data_ptr(), int(full_grads), int(packed_feats),
        torch.cuda.current_stream(feats.device).cuda_stream,
    )
    LAUNCHES["tile_blend_backward"] += 1
    return d_feats


# ---------------------------------------------------------------------------
# differentiable pieces: the slab gather with its regroup VJP, and the
# kernel pair as one autograd Function


def regroup_grads(d_feats, group_key, rank_of, seg_start, seg_end,
                  bf16_pack: bool, packed_feats: bool) -> torch.Tensor:
    """Transpose of the slab gather (the JAX `_make_expand_rows` VJP):
    d_feats [F, N] per-instance rows -> d_g24 [P, F_PAD] per Gaussian. One
    sort on `group_key` (the binning's depth rank; invalid slots carry P and
    sort past every run) groups each Gaussian's rows at its emission slots
    [seg_start, seg_end), `segment_sum_ranges` sums the runs, and `rank_of`
    un-ranks. Only the F_GRAD rows that can be nonzero ride the sort. With
    bf16_pack, row pairs ride as one bf16-pair word each (each per-instance
    gradient rounded to bf16 before the f32 sum); packed_feats slabs already
    carry their content gradients as such words."""
    from tpu_splat_torch.core.device import stage
    from tpu_splat_torch.kernels.segment_reduce import segment_sum_ranges

    with stage("regroup_sort"):
        perm = torch.sort(group_key, stable=True).indices
        if packed_feats:
            words = [_pack2_bits(d_feats[2 * k], d_feats[2 * k + 1]) for k in range(6)]
            srt = torch.stack(words + [d_feats[12 + k] for k in range(4)])[:, perm]
            hi, lo = _unpack2_bits(srt)
            # geometry rows 0..11 interleave; content c0 c1 c2 n0 (high
            # halves), n1 n2 refl (low halves)
            geo = torch.stack([hi[:6], lo[:6]], dim=1).reshape(12, -1)
            rows_T = torch.cat([geo, hi[6:10], lo[6:9]])
        elif bf16_pack:
            z = torch.zeros_like(d_feats[0])
            words = [_pack2_bits(d_feats[2 * k], d_feats[2 * k + 1] if 2 * k + 1 < F_GRAD else z)
                     for k in range((F_GRAD + 1) // 2)]
            hi, lo = _unpack2_bits(torch.stack(words)[:, perm])
            rows_T = torch.stack([hi, lo], dim=1).reshape(-1, hi.shape[1])[:F_GRAD]
        else:
            rows_T = d_feats[:F_GRAD][:, perm]
    with stage("segment_sum"):
        d_part = segment_sum_ranges(rows_T.contiguous(), seg_start, seg_end)
    d_g = d_part.T[rank_of.long()]
    return torch.cat([d_g, torch.zeros((d_g.shape[0], F_PAD - F_GRAD), dtype=d_g.dtype,
                                       device=d_g.device)], dim=1)


class _ExpandRows(torch.autograd.Function):
    """g24 [P, F_PAD] -> the kernel's feature-major slab [F_PAD | 16, N_cap]
    (one masked row gather); backward: `regroup_grads`."""

    @staticmethod
    def forward(ctx, g24, gid, valid, group_key, rank_of, seg_start, seg_end,
                bf16_pack, packed_feats):
        g_in = _pack_g16(g24) if packed_feats else g24
        ctx.save_for_backward(group_key, rank_of, seg_start, seg_end)
        ctx.flags = (bf16_pack, packed_feats)
        return torch.where(valid[:, None], g_in[gid.long()], 0.0).T.contiguous()

    @staticmethod
    def backward(ctx, d_feats):
        d_g24 = regroup_grads(d_feats.contiguous(), *ctx.saved_tensors, *ctx.flags)
        return (d_g24,) + (None,) * 8


class _BlendKernel(torch.autograd.Function):
    """The kernel pair: `tile_blend_forward`, whose backward is
    `tile_blend_backward` on the saved slab and out_px. wmax carries no
    gradient."""

    @staticmethod
    def forward(ctx, feats, starts, counts, org_x, org_y, full_grads, packed_feats,
                collect_wmax):
        out_px, wmax = tile_blend_forward(
            feats, starts, counts, org_x, org_y, train_shape=not full_grads,
            packed_feats=packed_feats, collect_wmax=collect_wmax,
        )
        ctx.save_for_backward(feats, starts, counts, org_x, org_y, out_px)
        ctx.flags = (full_grads, packed_feats)
        ctx.mark_non_differentiable(wmax)
        return out_px, wmax

    @staticmethod
    def backward(ctx, d_out_px, _d_wmax):
        from tpu_splat_torch.core.device import stage

        feats, starts, counts, org_x, org_y, out_px = ctx.saved_tensors
        full_grads, packed_feats = ctx.flags
        with stage("tile_blend_backward"):
            d_feats = tile_blend_backward(
                feats, starts, counts, org_x, org_y, out_px, d_out_px.contiguous(),
                full_grads=full_grads, packed_feats=packed_feats,
            )
        return (d_feats,) + (None,) * 7


def blend_kernel(feats, starts, counts, org_x, org_y, full_grads: bool = True,
                 packed_feats: bool = False, collect_wmax: bool = True):
    """Differentiable tile sweep -> (out_px, wmax). full_grads=False is the
    train-shaped pair (the forward skips the distortion / median channels,
    the backward their cotangent chains); packed_feats takes the 16-row
    bf16-content slab; collect_wmax=False drops the wmax writeback."""
    return _BlendKernel.apply(feats, starts, counts, org_x, org_y, full_grads,
                              packed_feats, collect_wmax)
