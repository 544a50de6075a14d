// Run decode for Hopper (sm_90a): for every slot i in [0, n_out), the run
// r with offsets[r] <= i < offsets[r+1] (the last run ends at total); write
// rows[k, i] = table[r, k] and j[i] = i - offsets[r], or zero rows and
// j = i where no run covers i.
//
// Replaces the TPU kernel tpu_splat/kernels/run_expand.py:run_expand (body
// _run_expand_kernel). The TPU has no fast gather, so that kernel DMAs a
// lane-packed window of the table and turns run membership into a one-hot
// MXU matmul with a 3-way bf16 split of every value. Hopper gathers rows
// directly, so this kernel keeps only what it computes.
//
// Design: one thread per slot, 256 slots per block. Every run below total
// has length >= 1, so slot i lies at most 127 runs past r0_sub[i / 128], the
// run covering slot 128 * (i / 128): the thread binary-searches offsets
// over that window of 128 runs (7 steps; a warp's 32 slots read the same
// few cache lines), then copies the run's K table values into the K
// feature-major output rows. Neighbouring threads write neighbouring slots
// of each row, so every store is coalesced; the table reads hit the same
// run for consecutive slots and are served from L1. Each value gets +0.0f,
// which turns -0.0 into +0.0 as the TPU kernel's dot does; nothing else is
// rounded, so integers stored in the table stay exact.
//
// Bound on this card: bytes. The table and offsets are read once ((K+1) x
// P x 4 B) and the rows and j written once ((K+1) x n_out x 4 B): the tight
// level 1 at the bench frame writes 12 x 3.98M x 4 B = 191 MB, ~0.06 ms at
// 3.35 TB/s.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
// -fPIC (tpu_splat_torch/kernels/build.py).

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int SUB = 128;  // slots per r0_sub entry

__global__ void __launch_bounds__(THREADS)
run_expand_kernel(const float* __restrict__ table, int n_runs, int k_cols,
                  const int* __restrict__ offsets, const int* __restrict__ total_p,
                  const int* __restrict__ r0_sub, int n_out,
                  float* __restrict__ rows, int* __restrict__ j_out) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n_out) return;
  int lo = __ldg(r0_sub + i / SUB);
  lo = lo < 0 ? 0 : (lo > n_runs ? n_runs : lo);
  int hi = min(lo + SUB - 1, n_runs - 1);
  int r = -1;
  if (lo <= hi && __ldg(offsets + lo) <= i) {
    while (lo < hi) {  // the last run in [lo, hi] that starts at or before i
      const int m = (lo + hi + 1) >> 1;
      if (__ldg(offsets + m) <= i) lo = m;
      else hi = m - 1;
    }
    const int end = lo < n_runs - 1 ? __ldg(offsets + lo + 1) : __ldg(total_p);
    if (i < end) r = lo;
  }
  if (r >= 0) {
    const float* row = table + (long long)r * k_cols;
    for (int k = 0; k < k_cols; ++k) rows[(long long)k * n_out + i] = __ldg(row + k) + 0.0f;
    j_out[i] = i - __ldg(offsets + r);
  } else {
    for (int k = 0; k < k_cols; ++k) rows[(long long)k * n_out + i] = 0.0f;
    j_out[i] = i;
  }
}

}  // namespace

// table [n_runs, k_cols] f32; offsets [n_runs] i32; total [] i32 (on the
// card); r0_sub [n_out / 128] i32; rows [k_cols, n_out] f32; j [n_out] i32.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int run_expand(const float* table, int n_runs, int k_cols, const int* offsets,
                          const int* total, const int* r0_sub, int n_out, float* rows,
                          int* j, void* stream) {
  if (n_out <= 0) return 0;
  const int blocks = (n_out + THREADS - 1) / THREADS;
  run_expand_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      table, n_runs, k_cols, offsets, total, r0_sub, n_out, rows, j);
  return (int)cudaGetLastError();
}

extern "C" const char* run_expand_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
