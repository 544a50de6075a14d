"""Tile binning: the 128-aligned per-tile instance layout of the tile
kernels, or the dense per-tile layout of the scan blend.

Port of tpu_splat/raster/binning.py (the role of the reference tile
scheduler, rasterizer_impl.cu:70-138): depth-argsort the Gaussians, expand
each one into capacity slots, count instances per tile, then
- `aligned=True` (the tile kernels): one sort by (tile, depth rank) lays
  every tile's instances out front to back in a 128-aligned exclusive
  range, with pad slots after them (`Binned`);
- `aligned=False` (the scan blend, `backend="xla"`): one stable sort by
  tile of the emitted Gaussian ids, cut into a dense `[T, tile_depth]`
  table per tile, truncated at `tile_depth` (`DenseBinned`).

The expansion comes in the JAX package's formulations:
- `expand_mode="gather"`: mark + cumsum + cummax + one row gather of each
  Gaussian's tile rect;
- `expand_mode="scan"` is accepted so configs spell the same in both
  packages, and runs as "gather": the JAX package's hold-last scans exist
  to avoid a TPU row gather, which the card does not need, and both give
  the same integers;
- `expand_mode="kernel"`: the `run_expand` kernel decodes the rect rows;
- `tight_culling` (aligned layout only, as in the JAX package): two levels
  of `run_expand`, Gaussians to tile columns, then each column to the tile
  rows its 3-sigma conic (union the low-pass disk) covers over that column
  (PARITY.md D2). Every column emits at least one instance (an
  out-of-image dummy when its range is empty), so each Gaussian's
  per-Gaussian run [seg_start, seg_end) holds its dummies too.
Both run-decode paths need `max_instances` (and for tight culling
`max_columns`) to be a multiple of 4096; otherwise kernel mode runs as
gather and tight culling is off, as in the JAX package. All modes give
the same integers.

The capacities are static, as in the JAX package: instances past
`max_instances` are dropped (the tail of the emission order, i.e. the
farthest ranks) and reported through `num_instances`; pads past the
`pad_per_tile` budget are reported through `pad_overflow`. So both packages
produce the same integers for the same inputs. Binning is not
differentiable; nothing here reads the host.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from tpu_splat_torch.core import f32
from tpu_splat_torch.core.device import stage
from tpu_splat_torch.kernels.run_expand import BLK as EXPAND_BLK, run_expand
from tpu_splat_torch.raster.config import CUTOFF, FILTER_SIZE, TILE, RasterConfig, tile_grid
from tpu_splat_torch.raster.preprocess import Preprocessed

INSTANCE_ALIGN = 128  # kernels/tile_blend.py CI
_I32_MAX = 2**31 - 1


class Binned(NamedTuple):
    num_instances: torch.Tensor  # [] int true instance count (overflow check)
    max_area: torch.Tensor  # [] int max tiles touched by one Gaussian
    tile_counts: torch.Tensor  # [T] int32 instances per tile (pre-truncation)
    tile_starts: torch.Tensor  # [T_padded] range start per tile in tile-sorted order
    aligned_gid: torch.Tensor  # [cap_al] Gaussian id per aligned slot
    aligned_valid: torch.Tensor  # [cap_al] bool
    aligned_starts: torch.Tensor  # [T_padded] int32 128-aligned range starts
    aligned_rank: torch.Tensor  # [cap_al] int32 depth rank (P where invalid)
    rank_of: torch.Tensor  # [P] gaussian id -> its depth rank
    seg_start: torch.Tensor  # [P] by rank: first emission slot
    seg_end: torch.Tensor  # [P] by rank: end emission slot
    pad_overflow: torch.Tensor  # [] pads beyond cfg.pad_per_tile budget


class DenseBinned(NamedTuple):
    """The scan blend's layout (`bin_gaussians(aligned=False)`; the JAX
    `Binned` with aligned=False, whose aligned fields are None)."""

    tile_gid: torch.Tensor  # [T_padded, K] per-tile depth-sorted Gaussian ids
    tile_mask: torch.Tensor  # [T_padded, K] bool, k < min(count, tile_depth)
    num_instances: torch.Tensor  # [] int true instance count (overflow check)
    max_area: torch.Tensor  # [] int max tiles touched by one Gaussian
    tile_counts: torch.Tensor  # [T] int32 instances per tile (pre-truncation)
    sorted_gid: torch.Tensor  # [cap] tile-sorted Gaussian ids
    tile_starts: torch.Tensor  # [T_padded] range start per tile in sorted_gid
    pad_overflow: torch.Tensor  # [] always 0: the layout has no pads


def _excl_cumsum(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x, 0) - x


def _expand_by_offsets(offsets: torch.Tensor, n_out: int) -> torch.Tensor:
    """Map each output slot i in [0, n_out) to the last range g with
    offsets[g] <= i (offsets nondecreasing)."""
    mark = torch.zeros(n_out + 1, dtype=torch.int64, device=offsets.device)
    mark.index_add_(
        0, torch.clamp(offsets, max=n_out).long(), torch.ones_like(offsets, dtype=torch.int64)
    )
    return torch.cumsum(mark[:n_out], 0) - 1


def _run_ranks(offsets: torch.Tensor, emitting: torch.Tensor, n_out: int) -> torch.Tensor:
    """[n_out] int64: for each slot, the rank of the last emitting run
    starting at or before it (-1 before the first). Runs that do not emit,
    or start at or past n_out, mark unique slots past it, so the count sees
    only the emitting prefix of the ranks."""
    P_ = offsets.shape[0]
    ids = torch.arange(P_, dtype=torch.int64, device=offsets.device)
    scat = torch.where(emitting & (offsets < n_out), offsets, n_out + ids)
    mark = torch.zeros(n_out + P_ + 1, dtype=torch.int64, device=offsets.device)
    mark.index_add_(0, scat, torch.ones_like(scat))
    return torch.cumsum(mark[:n_out], 0) - 1


def _run_starts(offsets: torch.Tensor, emitting: torch.Tensor, n_out: int) -> torch.Tensor:
    """[n_out // 128] int32: the run covering each 128th slot, as
    `run_expand` takes it."""
    return torch.clamp(_run_ranks(offsets, emitting, n_out)[::128], min=0).to(torch.int32)


# -- float32 arithmetic with the bits of the JAX package's jitted CPU code
# (core/f32.py): which product of x*y - z*w is fused was read off its results.

def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """jnp.cross as the JAX package computes it: each a_i*b_j - a_k*b_l is
    fma(a_i, b_j, -(a_k*b_l))."""
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack(
        [f32.fma(a1, b2, -(a2 * b1)), f32.fma(a2, b0, -(a0 * b2)), f32.fma(a0, b1, -(a1 * b0))], -1
    )


def _to_i32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> int32 values (as int64) the way XLA converts: saturating,
    NaN to 0."""
    x = torch.where(torch.isnan(x), torch.zeros_like(x), x)
    return torch.clamp(x.double(), -(2.0**31), float(_I32_MAX)).long()


def _wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values -> their int32 wrap-around (XLA's int32 add overflows)."""
    return torch.remainder(x + 2**31, 2**32) - 2**31


def _conic_column_params(prep: Preprocessed):
    """Per-Gaussian parameters of the 3-sigma screen conic, for the
    per-column y-extent (tpu_splat/raster/binning.py:_conic_column_params):
    the region {rho3d <= CUTOFF^2} = {qa x^2 + qb y^2 + qc xy + qd x + qe y
    + qf <= 0} of the blend's homography. Returns (ok, xc, yc, alpha, gamma,
    delta): the upper boundary V(u) = alpha*u + sqrt(gamma - delta*u^2)
    about the center (xc, yc); ok=False for degenerate conics."""
    Tu, Tv, Tw = prep.hom[:, 0, :], prep.hom[:, 1, :], prep.hom[:, 2, :]
    A, B, C = _cross(Tv, Tw), _cross(Tw, Tu), _cross(Tu, Tv)
    # scale-invariant: normalize so the quartic terms stay in float32 range
    n = torch.clamp(torch.stack([A, B, C], 1).abs().amax((1, 2)), min=1e-30)[:, None]
    A, B, C = A / n, B / n, C / n
    cut = CUTOFF * CUTOFF

    def q2(u, v):
        # u0*v0 + u1*v1 - cut*u2*v2, contracted as the JAX package's
        inner = f32.fma(u[:, 0], v[:, 0], u[:, 1] * v[:, 1])
        return f32.fma(-(cut * u[:, 2]), v[:, 2], inner)

    qa, qb = q2(A, A), q2(B, B)
    qc, qd, qe = 2.0 * q2(A, B), 2.0 * q2(A, C), 2.0 * q2(B, C)
    qf = q2(C, C)
    det = f32.fma(4.0 * qa, qb, -(qc * qc))
    ok = (qa > 1e-12) & (qb > 1e-12) & (det > 1e-12)
    one = torch.ones_like(det)
    sdet = torch.where(ok, det, one)
    xc = f32.fma(qc, qe, -2.0 * qb * qd) / sdet
    yc = f32.fma(qc, qd, -2.0 * qa * qe) / sdet
    R = -(qf + 0.5 * f32.fma(qd, xc, qe * yc))
    ok = ok & (R > 0) & torch.isfinite(xc) & torch.isfinite(yc)
    sqb = torch.where(ok, qb, one)
    zero = torch.zeros_like(det)
    alpha = torch.where(ok, -qc / (2.0 * sqb), zero)
    gamma = torch.where(ok, R / sqb, zero)
    delta = torch.where(ok, det / (4.0 * sqb * sqb), one)
    return ok, xc, yc, alpha, gamma, delta


def _column_y_range(rows1: torch.Tensor, j1: torch.Tensor, tiles_y: int):
    """Per-column tile-row range from the expanded level-1 rows (columns rx,
    gid, rank, xc, yc, alpha, gamma, delta, rl, px, py). Returns (ix, ty0,
    cnt) with cnt possibly 0 (tpu_splat/raster/binning.py:_column_y_range).
    The ellipse is tested about the conic center (xc, yc), the low-pass
    disk about the projected mean (px, py)."""
    rx = rows1[0].long()
    xc, yc, al, ga = rows1[3], rows1[4], rows1[5], rows1[6]
    de = torch.clamp(rows1[7], min=1e-20)
    rl, px, py = rows1[8], rows1[9], rows1[10]

    ix = rx + j1.long()
    x0 = ix.float() * TILE
    u0 = x0 - xc
    u1 = u0 + (TILE - 1)
    umax = f32.sqrt(torch.clamp(ga / de, min=0.0))
    u0c = torch.maximum(u0, -umax)
    u1c = torch.minimum(u1, umax)
    ell_on = (u0c <= u1c) & (ga > 0)
    # stationary point of the upper boundary V(u) = al*u + sqrt(ga - de*u^2)
    al2 = al * al  # two uses: not fused
    ut = torch.sign(al) * f32.sqrt(torch.clamp(al2 * ga / (de * (de + al2)), min=0.0))

    def V(u):
        return f32.fma(al, u, f32.sqrt(torch.clamp(f32.fma(-(de * u), u, ga), min=0.0)))

    y_hi_e = yc + V(torch.minimum(torch.maximum(ut, u0c), u1c))
    y_lo_e = yc - V(torch.minimum(torch.maximum(ut, -u1c), -u0c))
    v0 = x0 - px
    v1 = v0 + (TILE - 1)
    disk_on = (rl >= 0) & (v1 >= -rl) & (v0 <= rl)
    big = torch.full_like(xc, 3.4e38)
    y_hi = torch.maximum(torch.where(ell_on, y_hi_e, -big), torch.where(disk_on, py + rl, -big))
    y_lo = torch.minimum(torch.where(ell_on, y_lo_e, big), torch.where(disk_on, py - rl, big))
    any_on = ell_on | disk_on
    ty0 = torch.clamp(_to_i32(torch.floor(y_lo / TILE)), 0, tiles_y)
    ty1 = torch.clamp(_wrap_i32(_to_i32(torch.floor(y_hi / TILE)) + 1), 0, tiles_y)
    cnt = torch.where(any_on, torch.clamp(ty1 - ty0, min=0), torch.zeros_like(ty0))
    ty0 = torch.where(cnt > 0, ty0, torch.full_like(ty0, tiles_y))  # dummies key past the image
    return ix, ty0, cnt


def _tight_expand(prep, gorder, area_o, packed, rw_col, cap, cap_cols, tiles_y, tiles_x):
    """Two-level tight expansion (tpu_splat/raster/binning.py:278-395):
    Gaussians -> tile columns (level 1, one run per Gaussian of its rect
    width), then columns -> tiles (level 2, one run per column of its tight
    tile-row count, at least 1). Returns (inst_tile, inst_gid, gsel, total,
    seg_start, seg_end, num_instances, max_area)."""
    dev = prep.depth.device
    P_ = gorder.shape[0]
    n_tiles = tiles_y * tiles_x
    rank_ids = torch.arange(P_, dtype=torch.int64, device=dev)
    ok_c, xc_c, yc_c, al_c, ga_c, de_c = _conic_column_params(prep)
    # degenerate conics fall back to a flat band covering exactly the rect
    # rows: alpha 0, delta ~0, gamma (half height in px)^2
    ry0 = prep.rect_min[:, 1].float()
    ry1 = prep.rect_max[:, 1].float()
    mid = (ry0 + ry1) * (TILE / 2.0)
    halfh = torch.clamp((ry1 - ry0) * (TILE / 2.0) - 0.5, min=0.0)
    use = ok_c & prep.valid
    f = lambda x: torch.full_like(xc_c, x)
    xc_c = torch.where(use, xc_c, prep.xy[:, 0])
    yc_c = torch.where(use, yc_c, mid)
    al_c = torch.where(use, al_c, f(0.0))
    ga_c = torch.where(use, ga_c, halfh * halfh)
    de_c = torch.where(use, de_c, f(1e-18))
    rl_c = torch.where(use, f(CUTOFF * FILTER_SIZE), f(-1.0))

    # level 1: per-rank conic parameters expanded to tile columns
    with stage("tight_level1_decode"):
        area1_o = torch.where(area_o > 0, rw_col, torch.zeros_like(rw_col))
        off1 = _excl_cumsum(area1_o)
        total1 = area1_o.sum()
        r0_sub1 = _run_starts(off1, area1_o > 0, cap_cols)
        xy_o = prep.xy[gorder]
        tab1 = torch.stack(
            [(packed & 0x3FF).float(), gorder.float(), rank_ids.float(), xc_c[gorder],
             yc_c[gorder], al_c[gorder], ga_c[gorder], de_c[gorder], rl_c[gorder],
             xy_o[:, 0], xy_o[:, 1]],
            dim=1,
        )
        tot1c = torch.clamp(total1, max=cap_cols)
        rows1, j1 = run_expand(tab1, torch.clamp(off1, max=cap_cols).to(torch.int32),
                               tot1c.to(torch.int32), r0_sub1, cap_cols)
    with stage("tight_column_range"):
        icol = torch.arange(cap_cols, dtype=torch.int64, device=dev)
        col_valid = icol < tot1c
        ix, ty0, cnt_t = _column_y_range(rows1, j1, tiles_y)
        # every real column emits >= 1 instance (an out-of-image dummy when
        # its range is empty): run_expand's length >= 1 invariant at level 2
        cnt2 = torch.where(col_valid, torch.clamp(cnt_t, min=1), torch.zeros_like(cnt_t))
        off2 = _excl_cumsum(cnt2)
        total2 = cnt2.sum()
        r0_sub2 = _run_starts(off2, cnt2 > 0, cap)
        tab2 = torch.stack([ix.float(), ty0.float(), rows1[1], rows1[2]], dim=1)
    with stage("tight_level2_decode"):
        tot2c = torch.clamp(total2, max=cap)
        rows2, j2 = run_expand(tab2, torch.clamp(off2, max=cap).to(torch.int32),
                               tot2c.to(torch.int32), r0_sub2, cap)
    i = torch.arange(cap, dtype=torch.int64, device=dev)
    slot_valid = i < tot2c
    ty2 = rows2[1].long() + j2.long()
    inst_tile = torch.where(slot_valid, ty2 * tiles_x + rows2[0].long(),
                            torch.full_like(ty2, n_tiles))
    inst_gid = torch.where(slot_valid, rows2[2].long(), torch.zeros_like(ty2))
    gsel = rows2[3].long()
    # per-rank segment bounds: [instances at the rank's first column,
    # instances at the next rank's first column)
    off2_ext = torch.cat([off2, total2[None]])
    segs = torch.clamp(off2_ext[torch.clamp(off1, max=cap_cols)], max=cap)
    vr = area1_o > 0
    seg_start = torch.where(vr, segs, tot2c)
    seg_end = torch.where(vr, torch.cat([seg_start[1:], tot2c[None]]), tot2c)
    # occupancy, dummies included, is the growth signal; a column overflow
    # reports at least the capacity
    num_instances = torch.where(total1 > cap_cols, torch.clamp(total2, min=cap), total2)
    max_area = (seg_end - seg_start).max()
    return inst_tile, inst_gid, gsel, total2, seg_start, seg_end, num_instances, max_area


def bin_gaussians(
    prep: Preprocessed, height: int, width: int, cfg: RasterConfig, pad_tiles_to: int = 1,
    aligned: bool = True,
) -> Binned | DenseBinned:
    """Invariant: valid rows have tiles_touched > 0 (preprocess guarantees
    it; slab-clipped callers clear `valid` for zero-area rows), so zero-area
    rows sort past the emitting prefix.

    `aligned` as in the JAX package (there its default is False; every
    caller here but the scan blend wants the kernel layout): True gives
    `Binned`, False `DenseBinned` with tight culling off. `pad_tiles_to`
    pads the tile axis of the per-tile tables (tile_starts, aligned_starts,
    tile_gid, tile_mask) with empty tiles to a multiple of it, for a tile
    axis split over a mesh; tile_counts stays [T]."""
    dev = prep.depth.device
    tiles_y, tiles_x = tile_grid(height, width)
    if tiles_x > 1024 or tiles_y > 1024:
        # the packed rect word below has 10-bit x/y fields
        raise ValueError(
            f"image too large for packed tile coords: grid {tiles_x}x{tiles_y} "
            "(max 1024 tiles per axis = 16384 px)"
        )
    n_tiles = tiles_y * tiles_x
    n_tiles_padded = n_tiles + (-n_tiles) % pad_tiles_to
    cap = cfg.max_instances
    cap_cols = cfg.max_columns or cap
    mode = cfg.expand_mode
    tight = cfg.tight_culling and aligned
    if mode == "kernel" or tight:  # the run decode needs 4096-slot capacities
        if cap % EXPAND_BLK:
            tight = False
            if mode == "kernel":
                mode = "gather"
        elif tight and cap_cols % EXPAND_BLK:
            tight = False
    if tight:
        mode = "tight"
    P_ = prep.depth.shape[0]
    i64 = lambda x: x.to(torch.int64)
    prep = Preprocessed(*(x.detach() for x in prep))

    area = i64(prep.tiles_touched)  # [P], 0 for invalid

    # 1. stable depth argsort of the P Gaussians
    inf = torch.full_like(prep.depth, float("inf"))
    gkey = torch.where(prep.valid, prep.depth, inf)
    gorder = torch.sort(gkey, stable=True).indices  # [P] int64
    # rect word: rect.x | rect.y << 10 | rect_width << 20
    rmin = i64(prep.rect_min)
    rw_all = torch.clamp(i64(prep.rect_max[:, 0]) - rmin[:, 0], min=1)
    packed_all = rmin[:, 0] | (rmin[:, 1] << 10) | (rw_all << 20)
    area_o = area[gorder]
    packed = packed_all[gorder]
    rw_col = packed >> 20
    offsets = _excl_cumsum(area_o)
    total = area.sum()
    rank_ids = torch.arange(P_, dtype=torch.int64, device=dev)
    i = torch.arange(cap, dtype=torch.int64, device=dev)

    # 2. expansion: slot i -> covering Gaussian by depth rank
    num_instances = max_area = seg_start = seg_end = None
    if mode == "tight":
        (inst_tile, inst_gid, gsel, total, seg_start, seg_end, num_instances,
         max_area) = _tight_expand(prep, gorder, area_o, packed, rw_col, cap, cap_cols,
                                   tiles_y, tiles_x)
        slot_valid = i < torch.clamp(total, max=cap)
    elif mode == "kernel":
        # the run decode of [rx, ry, rw, gid, rank] per depth rank; integer
        # columns are exact in float32 (all < 2^23)
        tab = torch.stack([(packed & 0x3FF).float(), ((packed >> 10) & 0x3FF).float(),
                           rw_col.float(), gorder.float(), rank_ids.float()], dim=1)
        tot_c = torch.clamp(total, max=cap)
        rows, j = run_expand(tab, torch.clamp(offsets, max=cap).to(torch.int32),
                             tot_c.to(torch.int32), _run_starts(offsets, area_o > 0, cap), cap)
        slot_valid = i < tot_c
        rw = torch.clamp(rows[2].long(), min=1)
        j = j.long()
        tx = rows[0].long() + j % rw
        ty = rows[1].long() + torch.div(j, rw, rounding_mode="floor")
        inst_tile = torch.where(slot_valid, ty * tiles_x + tx, torch.full_like(tx, n_tiles))
        inst_gid = torch.where(slot_valid, rows[3].long(), torch.zeros_like(tx))
        gsel = rows[4].long()
    else:
        # "gather" (and "scan", see the module docstring): run decode + one
        # row gather: the depth rank of each slot, and the index within its
        # Gaussian's tile rect
        gsel = _run_ranks(offsets, area_o > 0, cap)  # [cap] depth rank per slot
        j = i - offsets[torch.clamp(gsel, min=0)]
        rows = torch.stack([packed, gorder], dim=1)[gsel]  # [cap, 2] row gather
        rows0, rows1 = rows[:, 0], rows[:, 1]
        slot_valid = i < torch.clamp(total, max=cap)
        rw = torch.clamp(rows0 >> 20, min=1)
        tx = (rows0 & 0x3FF) + j % rw
        ty = ((rows0 >> 10) & 0x3FF) + torch.div(j, rw, rounding_mode="floor")
        inst_tile = torch.where(slot_valid, ty * tiles_x + tx, torch.full_like(tx, n_tiles))
        inst_gid = torch.where(slot_valid, rows1, torch.zeros_like(rows1))

    # 3. per-tile counts: sort the tile ids, one searchsorted over n_tiles+1
    # integer boundaries (side-left of t+1 is side-right of t)
    sorted_tile_only = torch.sort(inst_tile).values
    se = torch.searchsorted(
        sorted_tile_only,
        torch.arange(n_tiles + 1, dtype=torch.int64, device=dev),
        side="left",
    )
    starts = se[:n_tiles]
    counts = se[1:] - starts
    if max_area is None:
        num_instances = total
        max_area = area.max() if P_ else torch.zeros((), dtype=torch.int64, device=dev)
    i32 = lambda x: x.to(torch.int32)
    tile_counts = i32(counts)
    if n_tiles_padded != n_tiles:
        zpad = torch.zeros(n_tiles_padded - n_tiles, dtype=starts.dtype, device=dev)
        starts, counts = torch.cat([starts, zpad]), torch.cat([counts, zpad])

    if not aligned:
        # the scan blend's layout: one stable payload sort by tile (emission
        # is depth-grouped, so each tile's ids come out front to back), then
        # the first tile_depth of each tile's range
        order = torch.sort(inst_tile, stable=True).indices
        sorted_gid = inst_gid[order]
        counts_capped = torch.clamp(counts, max=cfg.tile_depth)
        k = torch.arange(cfg.tile_depth, dtype=torch.int64, device=dev)[None, :]
        slots = torch.clamp(starts[:, None] + k, 0, cap - 1)
        return DenseBinned(
            tile_gid=i32(sorted_gid[slots]),
            tile_mask=k < counts_capped[:, None],
            num_instances=num_instances,
            max_area=max_area,
            tile_counts=tile_counts,
            sorted_gid=i32(sorted_gid),
            tile_starts=i32(starts),
            pad_overflow=torch.zeros((), dtype=torch.int64, device=dev),
        )

    # 4. one sort into the 128-aligned layout: append one pad instance per
    # missing slot (keyed by its tile) and sort by (tile, rank). (tile, rank)
    # is unique for real instances; pads and overflow slots carry rank P and
    # identical payloads, so the order is the JAX layout's exactly.
    al = INSTANCE_ALIGN
    aligned_counts = torch.div(counts + al - 1, al, rounding_mode="floor") * al
    aligned_starts = _excl_cumsum(aligned_counts)
    pad_counts = aligned_counts - counts
    pad_cap = n_tiles_padded * min(cfg.pad_per_tile, al)
    pad_off = _excl_cumsum(pad_counts)
    pad_tile = _expand_by_offsets(pad_off, pad_cap)
    npads = pad_counts.sum()
    pad_overflow = torch.clamp(npads - pad_cap, min=0)
    pad_ok = torch.arange(pad_cap, dtype=torch.int64, device=dev) < npads
    pad_tile = torch.where(pad_ok, pad_tile, torch.full_like(pad_tile, n_tiles_padded))

    key = torch.cat([inst_tile, pad_tile])
    gid_cat = torch.cat([inst_gid, torch.zeros(pad_cap, dtype=torch.int64, device=dev)])
    rank_cat = torch.cat(
        [
            torch.where(slot_valid, gsel, torch.full_like(gsel, P_)),
            torch.full((pad_cap,), P_, dtype=torch.int64, device=dev),
        ]
    )
    perm = torch.sort(key * (P_ + 1) + rank_cat).indices
    aligned_rank = rank_cat[perm]
    aligned_gid = gid_cat[perm]
    aligned_valid = aligned_rank < P_

    # 5. per-Gaussian segment bounds in emission space (rank r's instances
    # are slots [offsets[r], offsets[r] + area[r]), clipped at the capacity;
    # tight culling built its own)
    if seg_start is None:
        seg_start = torch.clamp(offsets, max=cap)
        seg_end = torch.clamp(offsets + area_o, max=cap)
    rank_of = torch.empty_like(gorder)
    rank_of[gorder] = rank_ids

    return Binned(
        num_instances=num_instances,
        max_area=max_area,
        tile_counts=tile_counts,
        tile_starts=i32(starts),
        aligned_gid=aligned_gid,
        aligned_valid=aligned_valid,
        aligned_starts=i32(aligned_starts),
        aligned_rank=i32(aligned_rank),
        rank_of=i32(rank_of),
        seg_start=i32(seg_start),
        seg_end=i32(seg_end),
        pad_overflow=pad_overflow,
    )
