"""Cubemap texel-gradient accumulation: `cubemap_tap_accumulate`.

Port of tpu_splat/kernels/cubemap_accum.py:cubemap_tap_accumulate. The
deferred-reflection pass samples the learned cubemap at every pixel with
four bilinear taps; its backward reduces the per-tap gradients into the
texture: d_tex[row * L + col] += w * g over pixels and taps, where a
separable pixel's taps are the 2x2 product of rows (r0, r1) weighted
(1-wr, wr)*m and columns (c0, c1) weighted (1-wc, wc), and every pixel adds
its 4 stored generic taps (zero weights for separable pixels).

The TPU kernel's `supported_resolution` gate is a VMEM limit; the port
serves every L. `cubemap_tap_accumulate` runs the CUDA kernel
(csrc/cubemap_accum.cu: a texel table per block, flushed with float
atomics) on CUDA tensors and the plain
PyTorch version beside it on CPU tensors.
"""
from __future__ import annotations

import ctypes

import torch

from tpu_splat_torch.kernels import LAUNCHES

MAX_C = 8  # channels the kernel takes


def tap_rows(tap_row, tap_col, tap_w, sep_r0, sep_r1, sep_c0, sep_c1,
             sep_wr, sep_wc, sep_m, L: int):
    """The taps of every pixel as (texel index [K, N], weight [K, N]): the
    4 separable products, then the 4 generic taps unless they are None
    (K = 8 or 4). Taps outside the [6L, L] texel grid get weight 0 (and a
    clamped index)."""
    a0, a1 = (1.0 - sep_wr) * sep_m, sep_wr * sep_m
    b0, b1 = 1.0 - sep_wc, sep_wc
    rows = torch.stack([sep_r0, sep_r0, sep_r1, sep_r1])
    cols = torch.stack([sep_c0, sep_c1, sep_c0, sep_c1])
    w = torch.stack([a0 * b0, a0 * b1, a1 * b0, a1 * b1])
    if tap_w is not None:
        rows, cols, w = torch.cat([rows, tap_row]), torch.cat([cols, tap_col]), torch.cat([w, tap_w])
    inside = (rows >= 0) & (rows < 6 * L) & (cols >= 0) & (cols < L)
    idx = torch.where(inside, rows.long() * L + cols.long(), 0)
    return idx, torch.where(inside, w, 0.0)


def cubemap_tap_accumulate_plain(g, tap_row, tap_col, tap_w, sep_r0, sep_r1,
                                 sep_c0, sep_c1, sep_wr, sep_wc, sep_m,
                                 L: int, C: int) -> torch.Tensor:
    """The plain PyTorch version: one index_add_ of the weighted tap rows
    (the separable weights as the kernel forms them: (1-wr)*m * ((1-wc)*g))."""
    a0, a1 = (1.0 - sep_wr) * sep_m, sep_wr * sep_m
    u0, u1 = (1.0 - sep_wc)[:, None] * g, sep_wc[:, None] * g
    idx, w = tap_rows(tap_row, tap_col, tap_w, sep_r0, sep_r1, sep_c0, sep_c1,
                      sep_wr, sep_wc, sep_m, L)
    vals = torch.cat([
        torch.stack([a0[:, None] * u0, a0[:, None] * u1,
                     a1[:, None] * u0, a1[:, None] * u1]),
        w[4:, :, None] * g[None],
    ])  # [K, N, C]
    vals = torch.where((w != 0.0)[..., None], vals, 0.0)
    out = torch.zeros((6 * L * L, C), dtype=torch.float32, device=g.device)
    out.index_add_(0, idx.reshape(-1), vals.reshape(-1, C))
    return out


def _check_inputs(g, named, C):
    """named: (name, tensor, dtype, shape) of every index/weight input."""
    if g.dtype != torch.float32 or g.dim() != 2 or g.shape[1] != C:
        raise ValueError(f"g must be float32 [N, {C}], got {g.dtype} {tuple(g.shape)}")
    if not 1 <= C <= MAX_C:
        raise ValueError(f"C must be in 1..{MAX_C}, got {C}")
    for name, x, dt, shape in named:
        if x.dtype != dt or tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {dt} {shape}, got {x.dtype} {tuple(x.shape)}")
        if x.device != g.device:
            raise ValueError(f"{name} is on {x.device}, g on {g.device}")


def cubemap_tap_accumulate(
    g: torch.Tensor,  # [N, C] output cotangents per pixel
    tap_row: torch.Tensor | None,  # [4, N] i32 row (face*L + y) per tap
    tap_col: torch.Tensor | None,  # [4, N] i32 column (x) per tap
    tap_w: torch.Tensor | None,  # [4, N] f32 tap weights, zero for separable pixels
    sep_r0: torch.Tensor,  # [N] i32
    sep_r1: torch.Tensor,
    sep_c0: torch.Tensor,
    sep_c1: torch.Tensor,
    sep_wr: torch.Tensor,  # [N] f32
    sep_wc: torch.Tensor,
    sep_m: torch.Tensor,  # [N] f32 1 = separable pixel, 0 = generic
    L: int,
    C: int,
) -> torch.Tensor:
    """-> d_tex [6*L*L, C] (flat texel rows, as texture.permute(0, 2, 3,
    1).reshape(-1, C)). tap_row, tap_col and tap_w are all None when every
    pixel is separable. CPU tensors take the plain version; CUDA tensors
    launch the kernel (or raise)."""
    N = g.shape[0]
    i32, f32 = torch.int32, torch.float32
    generic = [("tap_row", tap_row, i32, (4, N)), ("tap_col", tap_col, i32, (4, N)),
               ("tap_w", tap_w, f32, (4, N))]
    n_none = sum(x is None for _, x, _, _ in generic)
    if n_none not in (0, 3):
        raise ValueError("tap_row, tap_col and tap_w are all given or all None")
    _check_inputs(g, (generic if n_none == 0 else []) + [
        ("sep_r0", sep_r0, i32, (N,)), ("sep_r1", sep_r1, i32, (N,)),
        ("sep_c0", sep_c0, i32, (N,)), ("sep_c1", sep_c1, i32, (N,)),
        ("sep_wr", sep_wr, f32, (N,)), ("sep_wc", sep_wc, f32, (N,)),
        ("sep_m", sep_m, f32, (N,)),
    ], C)
    args = (g, tap_row, tap_col, tap_w, sep_r0, sep_r1, sep_c0, sep_c1,
            sep_wr, sep_wc, sep_m)
    if g.device.type == "cpu":
        return cubemap_tap_accumulate_plain(*args, L=L, C=C)
    if g.device.type != "cuda":
        raise ValueError(f"unsupported device {g.device}")
    from tpu_splat_torch.kernels import build

    args = tuple(None if x is None else x.contiguous() for x in args)
    out = torch.zeros((6 * L * L, C), dtype=torch.float32, device=g.device)
    p, i = ctypes.c_void_p, ctypes.c_int
    build.launch(
        "cubemap_accum", "cubemap_accum",
        [p, ctypes.c_longlong] + [p] * 10 + [i, i, p, p],
        args[0].data_ptr(), N, *(None if x is None else x.data_ptr() for x in args[1:]), L, C,
        out.data_ptr(), torch.cuda.current_stream(g.device).cuda_stream,
    )
    LAUNCHES["cubemap_tap_accumulate"] += 1
    return out
