"""Geometric capacity growth (port of tpu_splat/train/grow.py; the role of
the reference's resizable rasterizer buffers, rasterize_points.cu:31-37,
and of torch's parameter resize on densify).

Capacities are static, as in the JAX package: "allocation" pads every
capacity-sized leaf (Gaussian rows, Adam moments, densify statistics) to a
larger capacity and bumps the RasterConfig. The overflow diagnostics every
step reports (n_alive, num_instances, max_tile_count, densify overflow,
pad overflow) decide when; growth is geometric, so it happens O(log) times
in a run.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from tpu_splat_torch.kernels.run_expand import BLK as RUN_DECODE_BLK
from tpu_splat_torch.model.densify import DensifyStats
from tpu_splat_torch.raster.config import RasterConfig


def _round_up(x, align: int) -> int:
    return ((int(x) + align - 1) // align) * align


def _pad_rows(x, old_cap: int, new_cap: int, fill: float = 0.0, w_one: bool = False):
    """x padded from old_cap to new_cap rows with `fill` (False for a bool
    mask); anything not capacity-sized is returned as it is."""
    if not isinstance(x, torch.Tensor) or x.dim() == 0 or x.shape[0] != old_cap:
        return x
    pad_shape = (new_cap - old_cap,) + tuple(x.shape[1:])
    pad = torch.full(pad_shape, False if x.dtype == torch.bool else fill, dtype=x.dtype,
                     device=x.device)
    if w_one:
        pad[:, 0] = 1.0
    return torch.cat([x, pad])


def grow_capacity(ts, new_capacity: int):
    """Pad a TrainState's capacity-sized leaves to `new_capacity`: inert
    Gaussian rows (unit-w quaternions, log-scale and logits at -10, as
    init_from_pcd pads), zero moments and statistics (what
    densification_postfix gives new rows in the reference)."""
    g = ts.gaussians
    old = g.capacity
    assert new_capacity > old
    pad = lambda x, **kw: _pad_rows(x, old, new_capacity, **kw)
    g2 = dataclasses.replace(
        g,
        xyz=pad(g.xyz), features_dc=pad(g.features_dc), features_rest=pad(g.features_rest),
        scaling=pad(g.scaling, fill=-10.0), rotation=pad(g.rotation, w_one=True),
        opacity=pad(g.opacity, fill=-10.0), refl=pad(g.refl, fill=-10.0), alive=pad(g.alive),
    )
    opt2 = ts.opt._replace(mu={k: pad(v) for k, v in ts.opt.mu.items()},
                           nu={k: pad(v) for k, v in ts.opt.nu.items()})
    stats2 = DensifyStats(*(pad(x) for x in ts.stats))
    return dataclasses.replace(ts, gaussians=g2, opt=opt2, stats=stats2)


class GrowthDecision(NamedTuple):
    ts: object
    cfg: RasterConfig
    grew: bool
    reasons: tuple


def check_growth(
    ts,
    cfg: RasterConfig,
    n_alive: int,
    num_instances: int,
    max_tile_count: int,
    densify_overflow: int,
    pad_overflow: int = 0,
    headroom: float = 0.9,
    factor: float = 1.5,
) -> GrowthDecision:
    """Grow whatever is (nearly) full. Host control flow on host integers,
    called between steps (after a densify overflow and every 100
    iterations, as the trainer does). `max_tile_count` (the most instances
    one tile holds) grows `tile_depth` on the scan blend (backend="xla")
    only: it truncates each tile's list there, while the tile kernels'
    aligned ranges are bounded by max_instances alone."""
    reasons = []
    new_ts, new_cfg = ts, cfg

    cap = ts.gaussians.capacity
    if densify_overflow > 0 or n_alive > headroom * cap:
        new_cap = _round_up(max(cap * factor, n_alive + 1024), 256)
        new_ts = grow_capacity(ts, new_cap)
        reasons.append(f"capacity {cap} -> {new_cap}")

    changes = {}
    if num_instances > headroom * cfg.max_instances:
        # 4096-aligned so the run decode (tight culling, kernel mode) keeps
        # its capacity granularity
        changes["max_instances"] = _round_up(cfg.max_instances * factor, RUN_DECODE_BLK)
        reasons.append(f"max_instances {cfg.max_instances} -> {changes['max_instances']}")
        if cfg.max_columns:
            # tight mode reports a column overflow as num_instances >= cap,
            # so the column capacity grows with the instance capacity
            changes["max_columns"] = _round_up(
                max(cfg.max_columns * factor, changes["max_instances"]), RUN_DECODE_BLK
            )
            reasons.append(f"max_columns {cfg.max_columns} -> {changes['max_columns']}")
    if max_tile_count > cfg.tile_depth and not cfg.use_kernel():
        changes["tile_depth"] = _round_up(max_tile_count * factor, cfg.chunk)
        reasons.append(f"tile_depth {cfg.tile_depth} -> {changes['tile_depth']}")
    if pad_overflow > 0 and cfg.pad_per_tile < 128:
        # budgeted pad capacity overflowed: escalate to the exact worst case
        changes["pad_per_tile"] = 128
        reasons.append(f"pad_per_tile {cfg.pad_per_tile} -> 128")
    if changes:
        new_cfg = dataclasses.replace(cfg, **changes)

    return GrowthDecision(new_ts, new_cfg, bool(reasons), tuple(reasons))
