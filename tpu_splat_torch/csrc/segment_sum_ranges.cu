// Dense segmented row sum over ascending runs, for Hopper (sm_90a):
// out[f, r] = sum over j in [starts[r], ends[r]) of rows[f, j].
//
// Replaces the TPU kernel tpu_splat/kernels/segment_reduce.py:
// segment_sum_ranges (body _segsum_kernel). The TPU version turns segment
// membership into one-hot MXU matmuls over 512-row chunks fed by an 8-deep
// DMA ring; that is a workaround for the TPU's missing gather and slow
// scatter. This kernel keeps only what it computes.
//
// Design: one thread per segment, 256 segments per block. A thread walks
// its run in order for each of the F rows and writes out[f, r] once. Runs
// are ascending and adjacent, so the 32 threads of a warp read one stretch
// of each row together (the per-row reads of a warp fall in a few 32-byte
// sectors, reused through L1), and the writes out[f, r..r+31] are
// coalesced. Sums are float32 in run order: deterministic, no atomics, and
// the same order as the plain version's index_add_ on the CPU. F needs no
// padding; an empty run (start == end) gives 0.
//
// Bound on this card: bytes. Every row element is read once (F x N x 4 B)
// and every output written once (F x P x 4 B); the regroup of the bench
// frame reads 19 x 4.76M x 4 B = 0.36 GB, ~0.11 ms at 3.35 TB/s.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
// -fPIC (tpu_splat_torch/kernels/build.py).

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
segment_sum_ranges_kernel(const float* __restrict__ rows, long long n, int n_rows,
                          const int* __restrict__ starts,
                          const int* __restrict__ ends, int n_seg,
                          float* __restrict__ out) {
  const int r = blockIdx.x * THREADS + threadIdx.x;
  if (r >= n_seg) return;
  long long s = starts[r], e = ends[r];
  s = s < 0 ? 0 : (s > n ? n : s);
  e = e < 0 ? 0 : (e > n ? n : e);
  if (e < s) e = s;
  for (int f = 0; f < n_rows; ++f) {
    const float* row = rows + (long long)f * n;
    float acc = 0.f;
    for (long long j = s; j < e; ++j) acc += __ldg(row + j);
    out[(long long)f * n_seg + r] = acc;
  }
}

}  // namespace

// rows [n_rows, n] f32 (row stride n); starts/ends [n_seg] i32; out
// [n_rows, n_seg] f32. Launches on `stream` and returns cudaGetLastError().
extern "C" int segment_sum_ranges(const float* rows, long long n, int n_rows,
                                  const int* starts, const int* ends,
                                  int n_seg, float* out, void* stream) {
  if (n_seg <= 0) return 0;
  const int blocks = (n_seg + THREADS - 1) / THREADS;
  segment_sum_ranges_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      rows, n, n_rows, starts, ends, n_seg, out);
  return (int)cudaGetLastError();
}

extern "C" const char* segment_sum_ranges_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
