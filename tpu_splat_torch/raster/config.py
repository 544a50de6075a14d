"""Static rasterizer configuration (capacities fixed per config).

Port of `tpu_splat/raster/config.py`. The capacities and truncation
semantics are kept as they are in the JAX package (static `max_instances`,
`pad_per_tile`), so the two packages produce identical instance layouts.

`backend`:
- "auto" and "pallas" (kept so configs spell the same in both packages)
  select the tile-kernel path: the 128-aligned instance layout and the
  CUDA kernel pair for CUDA tensors, their plain PyTorch versions for CPU
  tensors.
- "xla" selects the scan blend (`raster/blend.py:blend`): the dense
  per-tile `[T, tile_depth]` layout consumed `chunk` instances at a time by
  chunked prefix products, in plain PyTorch on whatever device the tensors
  are on, differentiated by autograd. Per-tile lists are truncated at
  `tile_depth` (`check_growth` grows it from `max_tile_count`).
  `bf16_feats`, `bf16_grads` and `grad_channels` do not apply to it: it
  blends and differentiates every channel in the inputs' dtype, as the JAX
  scan does.
Departure from the JAX package: there "auto" resolves to the XLA scan off a
TPU (tpu_splat/raster/config.py:use_pallas). Here "auto" always means the
tile kernel, which is the production path on the card and the tested path
on the CPU; the scan is taken only when asked for by name.
"""
from __future__ import annotations

import dataclasses


TILE = 16  # pixels per tile side (reference config.h BLOCK_X/BLOCK_Y)
TILE_PIX = TILE * TILE

# Blending constants (reference auxiliary.h:41-44)
NEAR_N = 0.2
FAR_N = 100.0
FILTER_SIZE = 0.707106  # sqrt(2)/2 low-pass radius
FILTER_INV_SQUARE = 2.0
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4  # transmittance termination
CUTOFF = 3.0  # 3-sigma splat extent


@dataclasses.dataclass(frozen=True)
class RasterConfig:
    """Static capacities and switches; field meanings as in the JAX
    `RasterConfig` (tpu_splat/raster/config.py)."""

    max_tiles_per_gaussian: int = 64
    max_instances: int = 1 << 20  # global (gaussian, tile) instance capacity
    tile_depth: int = 1024
    chunk: int = 32
    depth_ratio: float = 0.0
    backend: str = "auto"  # "auto" | "pallas" (tile kernel) | "xla" (scan blend)
    grad_channels: str = "full"  # "full" | "train" (train-shaped kernel)
    bf16_grads: bool = False
    bf16_feats: bool = False  # bf16-pair content rows in the instance slab
    tight_culling: bool = False  # two-level per-column binning (run_expand)
    max_columns: int = 0  # level-1 (tile column) capacity; 0 = max_instances
    pad_per_tile: int = 128  # per-tile pad budget of the 128-aligned layout
    opacity_rect: bool = False  # opacity-aware tile rect (output-exact)
    circular_rect: bool = False  # reference-exact circular tile rect
    expand_mode: str = "gather"  # "gather" | "scan" (runs as "gather") | "kernel" (run_expand)

    def __post_init__(self):
        assert self.tile_depth % self.chunk == 0
        assert self.backend in ("auto", "xla", "pallas"), self.backend
        assert self.grad_channels in ("full", "train"), self.grad_channels
        assert self.expand_mode in ("gather", "scan", "kernel"), self.expand_mode
        assert 1 <= self.pad_per_tile <= 128, self.pad_per_tile
        if self.grad_channels == "train":
            assert self.depth_ratio == 0.0, (
                "grad_channels='train' requires depth_ratio == 0"
            )
        if self.bf16_feats:
            assert self.bf16_grads, "bf16_feats requires bf16_grads"

    def use_kernel(self) -> bool:
        """The tile-kernel path ("auto", "pallas"), not the scan blend."""
        return self.backend != "xla"

    @property
    def n_chunks(self) -> int:
        return self.tile_depth // self.chunk


def production_config(**overrides) -> RasterConfig:
    """The shipped switch set (tpu_splat/raster/config.py:production_config):
    train-shaped kernel, bf16 content rows, opacity-aware rect, gather
    expansion, 96-slot pad budget. Capacities come from the caller."""
    base = dict(
        backend="auto",
        grad_channels="train",
        bf16_grads=True,
        bf16_feats=True,
        tight_culling=False,
        opacity_rect=True,
        expand_mode="gather",
        pad_per_tile=96,
    )
    base.update(overrides)
    return RasterConfig(**base)


def production_switches(cfg: RasterConfig) -> dict:
    """The switch block an artifact embeds (capacity knobs excluded)."""
    return {
        "backend": cfg.backend,
        "grad_channels": cfg.grad_channels,
        "bf16_grads": cfg.bf16_grads,
        "bf16_feats": cfg.bf16_feats,
        "tight_culling": cfg.tight_culling,
        "opacity_rect": cfg.opacity_rect,
        "expand_mode": cfg.expand_mode,
        "pad_per_tile": cfg.pad_per_tile,
    }


def tile_grid(height: int, width: int) -> tuple[int, int]:
    return (height + TILE - 1) // TILE, (width + TILE - 1) // TILE
