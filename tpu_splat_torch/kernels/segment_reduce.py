"""Dense segmented row sum over ascending runs: `segment_sum_ranges`.

Port of tpu_splat/kernels/segment_reduce.py:segment_sum_ranges. It computes
out[:, r] = sum over j in [starts[r], ends[r]) of rows_T[:, j] for runs that
are ascending and do not overlap (gaps allowed). This is the reduction
behind the backward regroup: per-instance gradient rows, sorted by the
Gaussian they belong to, become per-Gaussian gradients.

`segment_sum_ranges` runs the CUDA kernel (csrc/segment_sum_ranges.cu) on
CUDA tensors and the plain PyTorch version beside it on CPU tensors.
"""
from __future__ import annotations

import ctypes

import torch

from tpu_splat_torch.kernels import LAUNCHES


def _clamped_runs(starts, ends, n):
    s = torch.clamp(starts.long(), 0, n)
    e = torch.maximum(torch.clamp(ends.long(), 0, n), s)
    return s, e


def segment_sum_ranges_plain(rows_T: torch.Tensor, starts: torch.Tensor,
                             ends: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: every covered column is tagged with its
    run and added into that run's column with one index_add_, in run order
    (sequential on the CPU, the kernel's order)."""
    F, N = rows_T.shape
    P_ = starts.shape[0]
    s, e = _clamped_runs(starts, ends, N)
    lens = e - s
    seg = torch.repeat_interleave(torch.arange(P_, device=rows_T.device), lens)
    first = torch.cumsum(lens, 0) - lens  # position of each run's first column
    cols = torch.repeat_interleave(s - first, lens) + torch.arange(
        seg.shape[0], device=rows_T.device
    )
    out = torch.zeros((F, P_), dtype=torch.float32, device=rows_T.device)
    out.index_add_(1, seg, rows_T[:, cols].float())
    return out


def _check_inputs(rows_T, starts, ends):
    if rows_T.dtype != torch.float32 or rows_T.dim() != 2:
        raise ValueError(
            f"rows_T must be float32 [F, N], got {rows_T.dtype} {tuple(rows_T.shape)}"
        )
    P_ = starts.shape[0]
    for name, x in (("starts", starts), ("ends", ends)):
        if x.dtype != torch.int32 or x.shape != (P_,):
            raise ValueError(f"{name} must be int32 [{P_}], got {x.dtype} {tuple(x.shape)}")
        if x.device != rows_T.device:
            raise ValueError(f"{name} is on {x.device}, rows_T on {rows_T.device}")


def segment_sum_ranges(
    rows_T: torch.Tensor,  # [F, N] feature-major rows
    starts: torch.Tensor,  # [P] int32 ascending run starts
    ends: torch.Tensor,  # [P] int32 run ends (ends[r] <= starts[r+1])
) -> torch.Tensor:
    """-> [F, P] per-run sums (0 for an empty run). CPU tensors take the
    plain version; CUDA tensors launch the kernel (or raise)."""
    _check_inputs(rows_T, starts, ends)
    if rows_T.device.type == "cpu":
        return segment_sum_ranges_plain(rows_T, starts, ends)
    if rows_T.device.type != "cuda":
        raise ValueError(f"unsupported device {rows_T.device}")
    from tpu_splat_torch.kernels import build

    rows_T, starts, ends = (x.contiguous() for x in (rows_T, starts, ends))
    F, N = rows_T.shape
    P_ = starts.shape[0]
    out = torch.empty((F, P_), dtype=torch.float32, device=rows_T.device)
    p, i = ctypes.c_void_p, ctypes.c_int
    build.launch(
        "segment_sum_ranges", "segment_sum_ranges",
        [p, ctypes.c_longlong, i, p, p, i, p, p],
        rows_T.data_ptr(), N, F, starts.data_ptr(), ends.data_ptr(), P_,
        out.data_ptr(), torch.cuda.current_stream(rows_T.device).cuda_stream,
    )
    LAUNCHES["segment_sum_ranges"] += 1
    return out
