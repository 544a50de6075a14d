"""Holds of one blend against another on the device (the tile-kernel path
against the scan blend, a frame against a reference), shared by
`chip_smoke.py` phase 11b and the parity CLI `tpu_splat_torch/tools/parity.py`.

`hold_images` compares two rasterizer outputs map by map at IMG_TOL and
counts the pixels whose n_contrib flipped; a pixel off tolerance without a
flip passes only where `knife_margins`, which runs the scan blend's layout
(recorded by `patched_blend`) in float64, finds a branch point of the blend
within KNIFE_BAND: an accept or median-rank flip that float32 rounding
decides either way.
"""
from __future__ import annotations

import contextlib

import torch

FLIPS_PER_4096 = 8  # n_contrib / median-rank flips at the T < 1e-4 knife edge
IMG_TOL = dict(color=(2e-5, 1e-4), final_T=(2e-5, 1e-4), refl_map=(2e-5, 1e-4),
               others=(5e-5, 1e-3))  # (abs, rel): tests/test_pallas.py:37-48
# a pixel off tolerance without an n_contrib flip must lie within this of a
# branch point of the blend in float64 (knife_margins)
KNIFE_BAND = 1e-5
FLIP_SHARE = 2.0 / 255.0  # one accept flip at alpha = 1/255: its own weight, and T behind it
KNIVES = ("accept", "terminate", "median", "lowpass", "unstable", "near")


def hold_images(got, want, label, near_knife=None):
    """A frame's maps against another's at IMG_TOL, as chip_smoke.py holds
    the kernel against its plain version: the errors are taken over the
    pixels whose n_contrib did not flip; flipped pixels are counted. A
    pixel off tolerance whose n_contrib did not flip passes only where
    `near_knife` ([H, W] bool, from knife_margins) says some (instance,
    pixel) pair there lies within KNIFE_BAND of a branch point in float64:
    an accept or a median-rank flip. There every channel bounded by 1
    (colour, T, reflection, alpha, normal, scope) stays within one flipped
    splat's share, FLIP_SHARE; the depth channels (depth, median depth,
    distortion) may jump, and are reported. Flipped and knife pixels share
    the budget FLIPS_PER_4096."""
    flip = got.n_contrib != want.n_contrib
    npx = flip.numel()
    off = torch.zeros_like(flip)
    diffs = {}
    for f, (atol, rtol) in IMG_TOL.items():
        a, b = getattr(got, f).detach(), getattr(want, f).detach()
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{label}: non-finite {f}")
        d = (a - b).abs()
        over = d > atol + rtol * b.abs()
        off |= over.any(-1) if over.dim() == 3 else over
        diffs[f] = d if d.dim() == 3 else d[..., None]
    knife = off & ~flip
    stray = knife if near_knife is None else knife & ~near_knife
    keep = ~flip & ~knife
    bounded = torch.cat([diffs["color"], diffs["final_T"], diffs["refl_map"],
                         diffs["others"][..., [1, 2, 3, 4, 7]]], -1)[knife]
    res = dict(ncon_flips=int(flip.sum()), knife_pixels=int(knife.sum()),
               stray_pixels=int(stray.sum()), pixels=npx,
               **{f: float(d.amax(-1)[keep].max()) for f, d in diffs.items()},
               knife_share=float(bounded.max()) if bounded.numel() else 0.0,
               knife_depth_jump=float(diffs["others"][..., [0, 5, 6]][knife].max())
               if bool(knife.any()) else 0.0)
    if (res["stray_pixels"] or res["knife_share"] > FLIP_SHARE
            or res["ncon_flips"] + res["knife_pixels"] > FLIPS_PER_4096 * npx / 4096):
        raise AssertionError(f"{label}: {res}")
    return res


def env_texel_coords(cam, normal: torch.Tensor, resolution: int):
    """Where each pixel's reflected ray reads a resolution^2 cubemap, as
    `sample_cubemap`'s filter computes it from the world normal map:
    (face [H, W], [H, W, 2] texel coordinates whose floor is the bilinear
    cell's corner)."""
    from tpu_splat_torch.core.graphics import camera_rays, reflect
    from tpu_splat_torch.envmap.cubemap import _face_uv

    face, u, v = _face_uv(reflect(camera_rays(cam), normal))
    v = -v
    su = (u * 0.5 + 0.5) * resolution
    sv = (v * 0.5 + 0.5) * resolution
    return face.long(), torch.stack([su - 0.5, sv - 0.5], -1)


def env_cells(cam, normal: torch.Tensor, resolution: int) -> torch.Tensor:
    """[H, W, 3] (face, x0, y0): the bilinear cell each pixel's reflected ray
    reads (`env_texel_coords`). The sample's gradient with respect to the
    direction jumps where a ray crosses from one cell to the next, so two
    frames whose normals differ in the last bit can send a pixel's gradient
    to different texel pairs: compare their cells."""
    face, xy = env_texel_coords(cam, normal, resolution)
    return torch.cat([face[..., None], torch.floor(xy).long()], -1)


@contextlib.contextmanager
def patched_blend(dtype=None, record=None):
    """rasterize's scan blend with its float inputs cast to `dtype` and its
    outputs rounded back to theirs (the rest of the step unchanged), and/or
    its inputs appended, detached, to `record`."""
    import tpu_splat_torch.raster as rp
    from tpu_splat_torch.raster.blend import BlendOutput, blend

    def wrapped(tile_gid, tile_mask, hom, xy, opa, nrm, col, refl, scope, bg, h, w, cfg, **kw):
        if record is not None:
            record.append(dict(tile_gid=tile_gid, tile_mask=tile_mask, hom=hom.detach(),
                               xy=xy.detach(), opacity=opa.detach(), cfg=cfg, size=(h, w)))
        if dtype is None:
            return blend(tile_gid, tile_mask, hom, xy, opa, nrm, col, refl, scope, bg, h, w, cfg,
                         **kw)
        dt0 = hom.dtype
        up = [t.to(dtype) for t in (hom, xy, opa, nrm, col, refl)]
        o = blend(tile_gid, tile_mask, *up, scope, bg.to(dtype), h, w, cfg, **kw)
        return BlendOutput(**{k: (v.to(dt0) if v.is_floating_point() else v)
                              for k, v in o._asdict().items()})

    rp.blend = wrapped
    try:
        yield
    finally:
        rp.blend = blend


def knife_margins(rec):
    """How near each of the blend's branch points every Gaussian and every
    pixel comes, in float64 on the scan blend's layout `rec` (a
    patched_blend record): for each knife, the least relative distance over
    the (instance, pixel) pairs where the branch decides something:
    accept, alpha = o*G against 1/255 on pairs reached; terminate,
    T*(1-alpha) against 1e-4 on pairs accepted; median, T against 0.5 on
    pairs contributing; lowpass, the ray-splat rho3d against the screen
    filter's rho2d on pairs contributing (the branch routes the gradient to
    the homography or to the centre); unstable, |p2| against 1e-4 in units
    of the products it cancels; near, depth against the near plane.
    Returns ([6, P] per Gaussian, [6, H, W] per pixel, [P] contributing
    pixels per Gaussian)."""
    from tpu_splat_torch.raster.blend import _excl_cumprod, _excl_cumsum, _tiles_to_image, tile_origins
    from tpu_splat_torch.raster.config import (ALPHA_MAX, ALPHA_MIN, FILTER_INV_SQUARE, NEAR_N,
                                               T_EPS, TILE, TILE_PIX, tile_grid)

    dt = torch.float64
    gid, gmask, cfg = rec["tile_gid"], rec["tile_mask"], rec["cfg"]
    h_, w_ = rec["size"]
    hom, xy, opa = (rec[k].to(dt) for k in ("hom", "xy", "opacity"))
    dev, n_t, P = gid.device, gid.shape[0], hom.shape[0]
    C, S, L = cfg.chunk, cfg.n_chunks, TILE_PIX
    org = tile_origins(h_, w_, device=dev)
    lane = torch.arange(L, device=dev)
    pixx = (org[:, 0:1] + lane[None] % TILE).to(dt)[:, None, :]
    pixy = (org[:, 1:2] + lane[None] // TILE).to(dt)[:, None, :]
    inf = torch.tensor(float("inf"), dtype=dt, device=dev)
    g_m = torch.full((len(KNIVES), P), float("inf"), dtype=dt, device=dev)
    p_m = torch.full((len(KNIVES), n_t, L), float("inf"), dtype=dt, device=dev)
    n_px = torch.zeros(P, dtype=torch.int64, device=dev)
    T = torch.ones((n_t, L), dtype=dt, device=dev)
    done = torch.zeros((n_t, L), dtype=torch.bool, device=dev)
    ids_s, mask_s = gid.reshape(n_t, S, C).long(), gmask.reshape(n_t, S, C)
    with torch.no_grad():
        for s in range(S):
            ids, vm = ids_s[:, s], mask_s[:, s]
            if not bool(vm.any()):
                break
            hm = hom[ids]
            Tu, Tv, Tw = hm[..., 0, :], hm[..., 1, :], hm[..., 2, :]
            c = lambda v, i: v[..., i : i + 1]
            k0, k1, k2 = (pixx * c(Tw, i) - c(Tu, i) for i in range(3))
            l0, l1, l2 = (pixy * c(Tw, i) - c(Tv, i) for i in range(3))
            p0, p1, p2 = k1 * l2 - k2 * l1, k2 * l0 - k0 * l2, k0 * l1 - k1 * l0
            cancel = torch.clamp((k0 * l1).abs() + (k1 * l0).abs(), min=1e-300)
            unstable = p2.abs() < 1e-4
            safe = torch.where(unstable, torch.ones_like(p2), p2)
            sx, sy = p0 / safe, p1 / safe
            rho3d = torch.where(unstable, torch.full_like(p2, 1e8), sx * sx + sy * sy)
            g = xy[ids]
            rho2d = FILTER_INV_SQUARE * ((c(g, 0) - pixx) ** 2 + (c(g, 1) - pixy) ** 2)
            depth = sx * c(Tw, 0) + sy * c(Tw, 1) + c(Tw, 2)
            araw = opa[ids][..., None] * torch.exp(-0.5 * torch.minimum(rho3d, rho2d))
            alpha = torch.clamp(araw, max=ALPHA_MAX)
            live = vm[..., None] & ~done[:, None, :]
            accept = (depth >= NEAR_N) & (alpha >= ALPHA_MIN) & live
            Tb = T[:, None, :] * _excl_cumprod(1.0 - torch.where(accept, alpha, 0.0), 1)
            trigger = accept & (Tb * (1.0 - alpha) < T_EPS)
            term_excl = _excl_cumsum(trigger.to(torch.int32), 1) > 0
            contrib = accept & ~term_excl & ~trigger
            reached = live & ~term_excl
            m = (torch.where(reached & (depth >= NEAR_N), (araw - ALPHA_MIN).abs() / ALPHA_MIN, inf),
                 torch.where(accept & ~term_excl, (Tb * (1.0 - alpha) - T_EPS).abs() / T_EPS, inf),
                 torch.where(contrib, (Tb - 0.5).abs() / 0.5, inf),
                 torch.where(contrib & ~unstable,
                             (rho3d - rho2d).abs() / torch.maximum(rho3d, rho2d), inf),
                 torch.where(reached, (p2.abs() - 1e-4).abs() / cancel, inf),
                 torch.where(reached & (alpha >= ALPHA_MIN), (depth - NEAR_N).abs() / NEAR_N, inf))
            flat = ids.reshape(-1)
            for i, v in enumerate(m):
                g_m[i].scatter_reduce_(0, flat, v.amin(2).reshape(-1), "amin")
                p_m[i] = torch.minimum(p_m[i], v.amin(1))
            n_px.index_add_(0, flat, contrib.sum(2).reshape(-1))
            T = T * torch.prod(1.0 - torch.where(contrib, alpha, 0.0), 1)
            done = done | trigger.any(1)
            del hm, k0, k1, k2, l0, l1, l2, p0, p1, p2, cancel, sx, sy, rho3d, rho2d, depth
            del araw, alpha, Tb, m
    ty, tx = tile_grid(h_, w_)
    return g_m, _tiles_to_image(p_m.permute(1, 2, 0), ty, tx, h_, w_).permute(2, 0, 1), n_px
