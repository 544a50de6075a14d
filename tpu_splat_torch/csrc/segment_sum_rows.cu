// Dense segmented row sum over ascending runs on row-major rows, for Hopper
// (sm_90a): out[r, f] = sum over j in [starts[r], ends[r]) of rows[j, f],
// for rows [n, F <= 32].
//
// Replaces the TPU kernel tpu_splat/kernels/segment_reduce.py:
// segment_sum_rows (body _segsum_rows_kernel). The TPU version pads the
// rows to 32 features, packs four rows into each 128-lane row for its DMAs
// and sums them with four one-hot MXU matmuls per 512-row chunk; all of
// that serves the TPU's lane tiling and missing gather. This kernel keeps
// only what it computes.
//
// Design: one warp per run, lane f owns feature f (lanes f >= F idle). The
// warp walks its run in order, and at each row its F lanes read F
// consecutive floats together (one or two 128-byte lines), so every read is
// coalesced and each row is read once; lane f writes out[r, f], so the
// run's F sums go out in one coalesced store. Sums are float32 in run
// order: deterministic, no atomics, the order of the plain version on the
// CPU. Bounds are clamped to [0, n]; an empty run gives 0.
//
// Bound on this card: bytes. Every covered row is read once (F x 4 B per
// row) and every sum written once (F x 4 B per run): the bench regroup's
// 4.76M rows of 19 features and 1,048,576 runs move ~0.44 GB, ~0.13 ms at
// 3.35 TB/s.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
// -fPIC (tpu_splat_torch/kernels/build.py).

#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;  // runs per block

__global__ void __launch_bounds__(WARPS * 32)
segment_sum_rows_kernel(const float* __restrict__ rows, long long n, int n_feat,
                        const int* __restrict__ starts, const int* __restrict__ ends,
                        int n_seg, float* __restrict__ out) {
  const int r = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int f = threadIdx.x & 31;
  if (r >= n_seg || f >= n_feat) return;
  long long s = __ldg(starts + r), e = __ldg(ends + r);
  s = s < 0 ? 0 : (s > n ? n : s);
  e = e < 0 ? 0 : (e > n ? n : e);
  float acc = 0.f;
  for (long long j = s; j < e; ++j) acc += __ldg(rows + j * n_feat + f);
  out[(long long)r * n_feat + f] = acc;
}

}  // namespace

// rows [n, n_feat] f32 (row stride n_feat <= 32); starts/ends [n_seg] i32;
// out [n_seg, n_feat] f32. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int segment_sum_rows(const float* rows, long long n, int n_feat,
                                const int* starts, const int* ends, int n_seg,
                                float* out, void* stream) {
  if (n_seg <= 0 || n_feat <= 0) return 0;
  const int blocks = (n_seg + WARPS - 1) / WARPS;
  segment_sum_rows_kernel<<<blocks, WARPS * 32, 0, (cudaStream_t)stream>>>(
      rows, n, n_feat, starts, ends, n_seg, out);
  return (int)cudaGetLastError();
}

extern "C" const char* segment_sum_rows_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
