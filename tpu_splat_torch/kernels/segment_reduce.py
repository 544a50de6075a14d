"""Dense segmented row sums over ascending runs: `segment_sum_ranges` and
`segment_sum_rows`.

Port of tpu_splat/kernels/segment_reduce.py. `segment_sum_ranges` computes
out[:, r] = sum over j in [starts[r], ends[r]) of rows_T[:, j] for runs that
are ascending and do not overlap (gaps allowed) on feature-major rows
[F, N]. This is the reduction behind the backward regroup: per-instance
gradient rows, sorted by the Gaussian they belong to, become per-Gaussian
gradients. `segment_sum_rows` has the same contract on row-major rows
[N, F <= 32] and gives [P, F].

Each runs its CUDA kernel (csrc/segment_sum_ranges.cu,
csrc/segment_sum_rows.cu) on CUDA tensors and the plain PyTorch version
beside it on CPU tensors.
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


MAX_ROW_F = 32  # features segment_sum_rows takes (one warp lane each)


def segment_sum_rows_plain(rows: torch.Tensor, starts: torch.Tensor,
                           ends: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of `segment_sum_rows`: the transpose of
    `segment_sum_ranges_plain` (each run summed in order)."""
    return segment_sum_ranges_plain(rows.T, starts, ends).T.contiguous()


def _check_rows_inputs(rows, starts, ends):
    if rows.dtype != torch.float32 or rows.dim() != 2:
        raise ValueError(
            f"rows must be float32 [N, F], got {rows.dtype} {tuple(rows.shape)}"
        )
    if rows.shape[1] > MAX_ROW_F:
        raise ValueError(f"segment_sum_rows supports F <= {MAX_ROW_F}, got {rows.shape[1]}")
    _check_inputs(rows.T, starts, ends)


def segment_sum_rows(
    rows: torch.Tensor,  # [N, F] row-major rows, F <= 32
    starts: torch.Tensor,  # [P] int32 ascending run starts
    ends: torch.Tensor,  # [P] int32 run ends (ends[r] <= starts[r+1])
) -> torch.Tensor:
    """-> [P, F] per-run sums, bounds clamped to [0, N] (0 for an empty
    run). CPU tensors take the plain version; CUDA tensors launch the
    kernel (or raise)."""
    _check_rows_inputs(rows, starts, ends)
    if rows.device.type == "cpu":
        return segment_sum_rows_plain(rows, starts, ends)
    if rows.device.type != "cuda":
        raise ValueError(f"unsupported device {rows.device}")
    from tpu_splat_torch.kernels import build

    rows, starts, ends = (x.contiguous() for x in (rows, starts, ends))
    N, F = rows.shape
    P_ = starts.shape[0]
    out = torch.empty((P_, F), dtype=torch.float32, device=rows.device)
    p, i = ctypes.c_void_p, ctypes.c_int
    build.launch(
        "segment_sum_rows", "segment_sum_rows",
        [p, ctypes.c_longlong, i, p, p, i, p, p],
        rows.data_ptr(), N, F, starts.data_ptr(), ends.data_ptr(), P_,
        out.data_ptr(), torch.cuda.current_stream(rows.device).cuda_stream,
    )
    LAUNCHES["segment_sum_rows"] += 1
    return out
