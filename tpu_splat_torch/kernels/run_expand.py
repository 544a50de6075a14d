"""Run decode: expand per-run table rows to per-slot rows (`run_expand`).

Port of tpu_splat/kernels/run_expand.py:run_expand. Binning's expansion
(the reference's duplicateWithKeys, rasterizer_impl.cu:70-111) maps every
slot i in [0, n_out) to the run r with offsets[r] <= i < offsets[r+1] (the
last run ends at `total`) and needs that run's table row and the index
j = i - offsets[r] within the run. Slots past the last run decode to zero
rows with j = i. Integer columns ride the table as exact float32 values,
so every offset and slot stays below 2^23.

`run_expand` launches the CUDA kernel (csrc/run_expand.cu) on CUDA tensors
and runs the plain PyTorch version beside it on CPU tensors. Both give the
JAX kernel's bits for a finite table: its one-hot MXU dot rebuilds each f32
exactly from a 3-way bf16 split and turns -0.0 into +0.0, which both
versions do by adding +0.0. (A NaN or inf anywhere in one of its 128-slot
windows would spread over the whole window there; here it stays in its
row.)
"""
from __future__ import annotations

import ctypes

import torch

from tpu_splat_torch.kernels import LAUNCHES

BLK = 4096  # n_out granularity (the TPU kernel's grid step)
SUB = 128  # slots per r0_sub entry
MAX_K = 14
MAX_SLOTS = 1 << 23  # offsets ride as exact f32 integers below this


def _check_inputs(table, offsets, total, r0_sub, n_out):
    """The JAX kernel's ValueErrors, in its order, then the wrapper's own
    type, shape and device checks."""
    if table.dim() != 2:
        raise ValueError(f"table must be [P, K], got {tuple(table.shape)}")
    P_, K = table.shape
    if K > MAX_K:
        raise ValueError(f"run_expand supports K <= 14, got {K}")
    if n_out % BLK:
        raise ValueError(f"n_out must be a multiple of {BLK}, got {n_out}")
    if n_out >= MAX_SLOTS:
        raise ValueError(
            f"run_expand capacity {n_out} >= 2^23: run offsets are exact "
            "f32 integers only below 8388608"
        )
    if r0_sub.shape != (n_out // SUB,):
        raise ValueError("r0_sub length must be n_out // 128")
    if table.dtype != torch.float32:
        raise ValueError(f"table must be float32, got {table.dtype}")
    for name, x, shape in (("offsets", offsets, (P_,)), ("total", total, ()),
                           ("r0_sub", r0_sub, (n_out // SUB,))):
        if x.dtype != torch.int32 or tuple(x.shape) != shape:
            raise ValueError(f"{name} must be int32 {list(shape)}, got {x.dtype} {tuple(x.shape)}")
        if x.device != table.device:
            raise ValueError(f"{name} is on {x.device}, table on {table.device}")


def run_expand_plain(table, offsets, total, r0_sub, n_out: int):
    """The plain PyTorch version: a searchsorted over the run starts, a row
    gather, slots outside every run masked. `r0_sub` is not needed."""
    P_, K = table.shape
    dev = table.device
    i = torch.arange(n_out, dtype=torch.int64, device=dev)
    if P_ == 0:
        return torch.zeros((K, n_out), dtype=torch.float32, device=dev), i.to(torch.int32)
    off = offsets.long()
    r = torch.searchsorted(off, i, right=True) - 1  # last run starting at or before i
    rc = torch.clamp(r, 0, P_ - 1)
    end = torch.cat([off[1:], total.long().reshape(1)])[rc]
    hit = (r >= 0) & (i < end)
    rows = torch.where(hit[:, None], table[rc] + 0.0, 0.0)
    j = torch.where(hit, i - off[rc], i)
    return rows.T.contiguous(), j.to(torch.int32)


def run_expand(
    table: torch.Tensor,  # [P, K] f32 per-run rows (ints as exact f32 < 2^23)
    offsets: torch.Tensor,  # [P] i32 ascending exclusive run starts
    total: torch.Tensor,  # [] i32 total slots (terminates the last run)
    r0_sub: torch.Tensor,  # [n_out // 128] i32 rank at each 128-slot boundary
    n_out: int,  # slot capacity, a multiple of 4096 below 2^23
) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (rows [K, n_out] f32 feature-major, j [n_out] i32):
    rows[:, i] = table[run(i)], j[i] = i - offsets[run(i)]; zero rows and
    j = i past the last run. Every run below `total` must have length >= 1
    and r0_sub[m] must be the run covering slot 128*m, as binning builds
    them. Not differentiable (binning structure): the table is detached."""
    table = table.detach()
    _check_inputs(table, offsets, total, r0_sub, n_out)
    if table.device.type == "cpu":
        return run_expand_plain(table, offsets, total, r0_sub, n_out)
    if table.device.type != "cuda":
        raise ValueError(f"unsupported device {table.device}")
    from tpu_splat_torch.kernels import build

    table, offsets, total, r0_sub = (x.contiguous() for x in (table, offsets, total, r0_sub))
    P_, K = table.shape
    rows = torch.empty((K, n_out), dtype=torch.float32, device=table.device)
    j = torch.empty((n_out,), dtype=torch.int32, device=table.device)
    p, c = ctypes.c_void_p, ctypes.c_int
    build.launch(
        "run_expand", "run_expand", [p, c, c, p, p, p, c, p, p, p],
        table.data_ptr(), P_, K, offsets.data_ptr(), total.data_ptr(), r0_sub.data_ptr(),
        n_out, rows.data_ptr(), j.data_ptr(),
        torch.cuda.current_stream(table.device).cuda_stream,
    )
    LAUNCHES["run_expand"] += 1
    return rows, j
