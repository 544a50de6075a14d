"""The yardstick's arithmetic: operations and bytes that a frame or a
training step needs at given inputs, and the peaks of the card.

Pair counts come from the plain reference's blend of the same inputs
(`reference/splat.py`, `want_counts`), so they count the work these inputs
need up to each pixel's termination, whatever implements the kernels. The
per-pair constants are those of the port's kernel bounds (chip_smoke.py,
`ALPHA_TEST_OPS`, `BWD_CONTRIB_OPS`, `bwd_bound`), frozen here.
"""
from __future__ import annotations

import torch

# one H100 SXM, NVIDIA's data sheet (dense, no sparsity; 700 W)
PEAK_F32_PER_S = 67e12
PEAK_BYTES_PER_S = 3.35e12

TILE_PIX = 256
OUT_ROWS = 16  # per-pixel output rows of a tile the forward writes
F_IN_PACKED = 16  # instance rows with bf16-paired content (training switch set)
F_IN_FULL = 24  # instance rows unpacked (the viewer's switch set)
CHUNK = 128  # instances a chunk of the kernels walks

ALPHA_TEST_OPS = 40  # f32 ops of one (instance, pixel) alpha test
FWD_CONTRIB_OPS = 24  # a contributing pair: T update, weight, 9 accumulations
BWD_CONTRIB_OPS = 86  # a contributing pair's reverse step in the backward


def blend_pairs(stats) -> dict:
    """Sum the per-tile, per-pixel counts of `splat.rasterize(...,
    want_counts=True)`: instances, alpha tests up to termination,
    alpha tests up to the last contributor, contributing pairs, and the
    instance columns the backward reads (each tile's chunks up to its last
    contributor)."""
    inst = tested = tested_bwd = contrib = cols = 0
    for tiles, counts, t_px, last, ncon in stats:
        inst += int(counts.sum())
        tested += int(t_px.sum())
        tested_bwd += int(last.sum())
        contrib += int(ncon.sum())
        used = (last.amax(1) + CHUNK - 1) // CHUNK
        cols += int(torch.minimum(counts, used * CHUNK).sum())
    return dict(instances=inst, alpha_tests=tested, alpha_tests_bwd=tested_bwd,
                contributing=contrib, bwd_columns=cols)


def blend_forward(p: dict, n_tiles: int, packed: bool) -> tuple[float, float]:
    """(operations, bytes) of the tile blend's forward: every alpha test up
    to the pixel's termination and each contributor's accumulation; each
    instance row read once, each tile's output rows written once."""
    rows = F_IN_PACKED if packed else F_IN_FULL
    n_bytes = p["instances"] * rows * 4 + n_tiles * OUT_ROWS * TILE_PIX * 4 + 4 * n_tiles * 4
    ops = ALPHA_TEST_OPS * p["alpha_tests"] + FWD_CONTRIB_OPS * p["contributing"]
    return float(ops), float(n_bytes)


def blend_backward(p: dict, n_tiles: int, packed: bool) -> tuple[float, float]:
    """(operations, bytes) of the tile blend's backward: the alpha test of
    every pair up to its pixel's last contributor and the reverse step of
    every contributor; the used columns read and their gradients written,
    the forward's and the cotangent's pixel rows read once."""
    rows = F_IN_PACKED if packed else F_IN_FULL
    n_bytes = (2 * p["bwd_columns"] * rows * 4 + 2 * n_tiles * OUT_ROWS * TILE_PIX * 4
               + 5 * n_tiles * 4)
    ops = ALPHA_TEST_OPS * p["alpha_tests_bwd"] + BWD_CONTRIB_OPS * p["contributing"]
    return float(ops), float(n_bytes)


def bound_s(ops: float, n_bytes: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(ops / PEAK_F32_PER_S, n_bytes / PEAK_BYTES_PER_S)
