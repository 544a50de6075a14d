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
// Bound on this card: bytes. Every covered row is read once (F x 4 B per
// row) and every sum written once (F x 4 B per run): the step's regroup
// rows, 4.58M covered rows of 19 features in 1,048,576 runs, move ~0.35 GB,
// ~0.10 ms at 3.35 TB/s.
//
// What held the first design back: one warp per run with lane f on feature
// f left 13 of 32 lanes idle at F = 19, read 76-byte rows that straddle
// 128-byte lines, and walked each run (~4.4 rows) as a chain of dependent
// loads: it was bound by load latency, not by bandwidth. This design: a
// block of 256 threads takes G = 64 consecutive runs. Runs ascend, so the
// rows they cover form one span; the block copies it into shared memory
// with 16-byte cp.async copies, all in flight at once (every lane busy,
// every line read whole), in windows of the buffer's size when the span is
// longer. Thread k then sums the (run, feature) items k, k + 256, ... of
// the block's [G, F] output from shared memory, each in run order from 0,
// carrying its sums across windows, and writes them: item j is
// out[r0 * F + j], so the stores are coalesced too. Sums are float32 in
// run order: the bits of the first design and of the plain version's order
// on the CPU. Bounds are clamped to [0, n]; an empty run gives 0; rows in
// gaps between runs are copied and not summed. What is left between it
// and the bound: a block's copy and its sums run one after the other, and
// overlap only across the six blocks an SM holds (kernel_ab.py times each
// phase alone).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
// -fPIC (tpu_splat_torch/kernels/build.py). -DSEGROWS_RUNS=n sets G (32
// or 64), -DSEGROWS_BUF=n the buffer's floats, -DSEGROWS_MIN_BLOCKS=n the
// blocks an SM the launch bound asks for (6 by default: the buffer allows
// six, and a block's copy and sums then overlap other blocks').

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef SEGROWS_RUNS
#define SEGROWS_RUNS 64
#endif
#ifndef SEGROWS_BUF
#define SEGROWS_BUF 8192
#endif
#ifndef SEGROWS_MIN_BLOCKS
#define SEGROWS_MIN_BLOCKS 6
#endif

namespace {

constexpr int THREADS = 256;
constexpr int G = SEGROWS_RUNS;               // runs per block
constexpr int ITEMS = G * 32 / THREADS;       // (run, feature) items a thread, F <= 32
constexpr int BUF = SEGROWS_BUF;              // floats of the row buffer
static_assert(G % 32 == 0 && G <= 64, "SEGROWS_RUNS: 32 or 64");

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem, int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ long long clamp_ll(long long x, long long n) {
  return x < 0 ? 0 : (x > n ? n : x);
}

__global__ void __launch_bounds__(THREADS, SEGROWS_MIN_BLOCKS)
segment_sum_rows_kernel(const float* __restrict__ rows, long long n, int n_feat,
                        const int* __restrict__ starts, const int* __restrict__ ends,
                        int n_seg, float* __restrict__ out) {
  __shared__ __align__(16) float s_buf[BUF];
  __shared__ int s_s[G], s_e[G];
  __shared__ unsigned s_lo[G / 32 + 1], s_hi[G / 32 + 1];

  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * G;
  const int nrun = min(G, n_seg - r0);
  const long long F = n_feat;

  // the block's runs, and the span of rows they cover (run bounds are
  // int32, so the span's ends reduce as unsigned words)
  if (tid < G) {
    int s = 0, e = 0;
    if (tid < nrun) {
      s = (int)clamp_ll(__ldg(starts + r0 + tid), n);
      e = (int)clamp_ll(__ldg(ends + r0 + tid), n);
      if (e < s) e = s;
    }
    s_s[tid] = s;
    s_e[tid] = e;
    const unsigned lo_w = __reduce_min_sync(0xffffffffu, e > s ? (unsigned)s : 0xffffffffu);
    const unsigned hi_w = __reduce_max_sync(0xffffffffu, e > s ? (unsigned)e : 0u);
    if ((tid & 31) == 0) {
      s_lo[tid >> 5] = lo_w;
      s_hi[tid >> 5] = hi_w;
    }
  }
  __syncthreads();
  long long lo = n, hi = 0;
#pragma unroll
  for (int w = 0; w < (G + 31) / 32; ++w) {
    if (s_lo[w] != 0xffffffffu) lo = min(lo, (long long)s_lo[w]);
    hi = max(hi, (long long)s_hi[w]);
  }

  float acc[ITEMS];  // this thread's items: item j is (run j / F, feature j % F)
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) acc[k] = 0.f;
  const int n_items = nrun * n_feat;

  // windows of whole rows; a window's first float is taken down to a
  // multiple of 4, so up to 3 floats of headroom and 3 of tail
  const long long wrows = (BUF - 8) / F;
  const bool vec = (reinterpret_cast<uintptr_t>(rows) & 15) == 0;
  const long long total = n * F;
  for (long long w0 = lo; w0 < hi; w0 += wrows) {
    const long long w1 = min(hi, w0 + wrows);
    const long long a0 = (w0 * F) & ~3LL;  // first float in the buffer
    const long long a1 = w1 * F;           // one past the last float needed
    if (vec) {
      // 16-byte copies, all in flight at once; the last one stops at the
      // end of the rows (the rest of its 16 bytes is zero-filled)
      const long long nq = (a1 - a0 + 3) / 4;
      for (long long qi = tid; qi < nq; qi += THREADS) {
        const long long g = a0 + qi * 4;
        const long long left = total - g;
        cp_async16(&s_buf[qi * 4], rows + g, left >= 4 ? 16 : (int)left * 4);
      }
    } else {
      for (long long x = a0 + tid; x < a1; x += THREADS) cp_async4(&s_buf[x - a0], rows + x);
    }
    cp_async_wait_all();
    __syncthreads();
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const int j = tid + k * THREADS;
      if (j < n_items) {
        const int r = j / n_feat;
        const long long s = max((long long)s_s[r], w0);
        const int len = (int)(min((long long)s_e[r], w1) - s);
        const float* p = s_buf + (s * F + (j - r * n_feat) - a0);
        float a = acc[k];
#pragma unroll 4
        for (int u = 0; u < len; ++u) a += p[u * n_feat];
        acc[k] = a;
      }
    }
    __syncthreads();  // before the next window overwrites the buffer
  }
#pragma unroll
  for (int k = 0; k < ITEMS; ++k)
    if (tid + k * THREADS < n_items) out[(long long)r0 * F + tid + k * THREADS] = acc[k];
}

// Ask for the largest shared-memory carveout once: six blocks of ~33 KB
// need 200 KB of the SM's 228 KB.
cudaError_t prepare() {
  static cudaError_t err = cudaFuncSetAttribute(
      segment_sum_rows_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  return err;
}

}  // namespace

// Blocks that fit on one SM, after prepare(); < 0 is a CUDA error.
extern "C" int segment_sum_rows_blocks_per_sm() {
  int n = 0;
  cudaError_t err = prepare();
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, segment_sum_rows_kernel, THREADS, 0);
  return err != cudaSuccess ? -(int)err : n;
}

// rows [n, n_feat] f32 (row stride n_feat <= 32); starts/ends [n_seg] i32;
// out [n_seg, n_feat] f32. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int segment_sum_rows(const float* rows, long long n, int n_feat,
                                const int* starts, const int* ends, int n_seg,
                                float* out, void* stream) {
  if (n_seg <= 0 || n_feat <= 0) return 0;
  const cudaError_t err = prepare();
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n_seg + G - 1) / G;
  segment_sum_rows_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      rows, n, n_feat, starts, ends, n_seg, out);
  return (int)cudaGetLastError();
}

extern "C" const char* segment_sum_rows_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
