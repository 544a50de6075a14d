// Cubemap texel-gradient accumulation for Hopper (sm_90a):
// d_tex[row * L + col, c] += w * g[i, c] over every pixel i and its taps.
//
// Replaces the TPU kernel tpu_splat/kernels/cubemap_accum.py:
// cubemap_tap_accumulate (body _tap_accum_kernel). The TPU version turns
// texel membership into one-hot MXU matmuls against a VMEM-resident
// accumulator, with a row window per block and a demotion rule for blocks
// whose rows span too wide; those are workarounds for the TPU's missing
// scatter and its VMEM budget (its `supported_resolution` gate). This kernel
// keeps only what they compute, and serves every resolution L.
//
// Taps: a separable pixel (sep_m != 0; every pixel of the seamless filter,
// which samples EdgeTable-padded faces) adds its 2x2 bilinear taps: rows
// r0/r1 with weights (1-wr)*m / wr*m times columns c0/c1 with weights
// (1-wc) / wc, as the TPU kernel's separable product. Every pixel also adds
// its 4 stored generic taps (tap_w, zero for separable pixels by the
// caller's contract; the seam and corner cases of the generic filter). A
// caller whose pixels are all separable passes null tap arrays, and the
// kernel then reads only the separable records. Taps outside [0, 6L) x
// [0, L) add nothing, as the one-hot membership there matches no texel.
//
// Bound on this card: bytes, at the bench frame (2,088,960 pixels, C = 3):
// the pixel records (g and the separable indices and weights, 10 words a
// pixel) read once and the texture gradient written once, 84.8 MB.
//
// What held the first design back: one thread per pixel sent its 4 x C
// float atomics straight to device memory, 25M of them at the bench step,
// and on a reflector many pixels fall in few texels (the busiest texel gets
// ~5,900 of the 8.4M live taps, the top 1% of texels 22%): their atomics
// serialise in the L2. It took 0.55 ms against 0.24 ms for one index_add_
// of the weighted taps.
//
// Design: each block privatizes its texels. A block of 512 pixels (one
// 16x32 tile in the caller's tile-major order) sums its taps into a
// 2048-slot texel table in shared memory (linear probing from a hash of
// the texel, shared-memory float atomics), then flushes each texel it
// touched to device memory with C atomics. Before the table, a warp groups
// its lanes by texel (__match_any_sync on the texel index) and sums each
// group's C values in a tree over the group (at most 5 rounds of C
// shuffles), so one lane a group touches the table. At the bench step the
// blocks flush 1.4M texel sums instead of 8.4M taps (a warp alone groups
// them into 6.4M). The per-texel sums still meet in float atomics, so their
// order changes from run to run: against the plain version the result
// differs by float32 rounding of the per-texel sums (the tests allow 1e-5
// of the largest |d_tex|).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
// -fPIC (tpu_splat_torch/kernels/build.py). kernel_ab.py times it against
// builds with -DCUBEMAP_TABLE=slots (0: no table, the groups' sums go to
// device memory) and -DCUBEMAP_THREADS=pixels a block.

#include <cuda_runtime.h>

namespace {

#ifndef CUBEMAP_THREADS
#define CUBEMAP_THREADS 512
#endif
#ifndef CUBEMAP_TABLE
#define CUBEMAP_TABLE 2048
#endif
constexpr int THREADS = CUBEMAP_THREADS;
constexpr unsigned FULL = 0xffffffffu;

// The block's texel table in shared memory: a power of two of slots,
// halved for wide C until it fits 40 KB of static shared memory.
template <int C>
__host__ __device__ constexpr int slots() {
  int s = CUBEMAP_TABLE;
  while (s * (C + 1) * 4 > 40960) s /= 2;
  return s;
}
static_assert((CUBEMAP_TABLE & (CUBEMAP_TABLE - 1)) == 0,
              "the table has a power of two of slots");

// Adds v to texel `key`: into its slot of the block table (linear probing
// from a hash), or straight to device memory when there is no table or it
// is full.
template <int C>
__device__ __forceinline__ void texel_add(int* s_key, float* s_val,
                                          float* __restrict__ out, int key,
                                          const float (&v)[C]) {
  constexpr int SLOTS = slots<C>();
  if (SLOTS > 0) {
    unsigned h = ((unsigned)key * 2654435761u) & (SLOTS - 1);
    for (int probe = 0; probe < SLOTS; ++probe, h = (h + 1) & (SLOTS - 1)) {
      const int prev = atomicCAS(s_key + h, -1, key);
      if (prev == -1 || prev == key) {
#pragma unroll
        for (int c = 0; c < C; ++c) atomicAdd(s_val + h * C + c, v[c]);
        return;
      }
    }
  }
#pragma unroll
  for (int c = 0; c < C; ++c) atomicAdd(out + (long long)key * C + c, v[c]);
}

// Adds w * gv to texel (row, col). Every lane of the warp calls it with
// the same control flow; a lane that adds nothing passes w = 0 (or an
// out-of-range texel).
template <int C>
__device__ __forceinline__ void add_tap(float* __restrict__ out, int row,
                                        int col, int L, int R, float w,
                                        const float (&gv)[C], int* s_key,
                                        float* s_val) {
  const bool live = w != 0.f && row >= 0 && row < R && col >= 0 && col < L;
  const int key = live ? row * L + col : -1;  // 6 L^2 texels fit an int
  float v[C];
#pragma unroll
  for (int c = 0; c < C; ++c) v[c] = w * gv[c];
  const int lane = threadIdx.x & 31;
  const unsigned peers = __match_any_sync(FULL, key);
  // Tree sum over the group: in round k a lane whose rank in the group has
  // its low k bits clear adds the sum held by the next such lane above it.
  // The group's first lane (rank 0) ends with the group's total.
  const int rank = __popc(peers & ((1u << lane) - 1u));
  unsigned above = peers & ~((2u << lane) - 1u);  // group lanes above this one
  int r = rank;
  while (__any_sync(FULL, above != 0u)) {
    const int next = above ? __ffs(above) - 1 : lane;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float t = __shfl_sync(FULL, v[c], next);
      if (above) v[c] += t;
    }
    // lanes with an odd rank have handed their sum on: drop them
    above &= ~__ballot_sync(FULL, r & 1);
    r >>= 1;
  }
  if (live && rank == 0) texel_add<C>(s_key, s_val, out, key, v);
}

template <int C>
__global__ void __launch_bounds__(THREADS)
cubemap_accum_kernel(const float* __restrict__ g, long long n,
                     const int* __restrict__ tap_row,
                     const int* __restrict__ tap_col,
                     const float* __restrict__ tap_w,
                     const int* __restrict__ sep_r0,
                     const int* __restrict__ sep_r1,
                     const int* __restrict__ sep_c0,
                     const int* __restrict__ sep_c1,
                     const float* __restrict__ sep_wr,
                     const float* __restrict__ sep_wc,
                     const float* __restrict__ sep_m, int L,
                     float* __restrict__ out) {
  constexpr int SLOTS = slots<C>();
  __shared__ int s_key[SLOTS > 0 ? SLOTS : 1];
  __shared__ float s_val[SLOTS > 0 ? SLOTS * C : 1];
  for (int k = threadIdx.x; k < SLOTS; k += THREADS) {
    s_key[k] = -1;
#pragma unroll
    for (int c = 0; c < C; ++c) s_val[k * C + c] = 0.f;
  }
  __syncthreads();
  // whole warps stay in the kernel: lanes past n add nothing
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  const bool in = i < n;
  const int R = 6 * L;
  float gv[C];
#pragma unroll
  for (int c = 0; c < C; ++c) gv[c] = in ? __ldg(g + i * C + c) : 0.f;
  const float m = in ? __ldg(sep_m + i) : 0.f;
  // separable taps (m == 0 leaves all four weights 0)
  const float wr = m != 0.f ? __ldg(sep_wr + i) : 0.f;
  const float wc = m != 0.f ? __ldg(sep_wc + i) : 0.f;
  const float a0 = (1.f - wr) * m, a1 = wr * m;
  const float b0 = 1.f - wc, b1 = wc;
  const int r0 = m != 0.f ? __ldg(sep_r0 + i) : -1;
  const int r1 = m != 0.f ? __ldg(sep_r1 + i) : -1;
  const int c0 = m != 0.f ? __ldg(sep_c0 + i) : -1;
  const int c1 = m != 0.f ? __ldg(sep_c1 + i) : -1;
  float u0[C], u1[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    u0[c] = b0 * gv[c];
    u1[c] = b1 * gv[c];
  }
  add_tap<C>(out, r0, c0, L, R, a0, u0, s_key, s_val);
  add_tap<C>(out, r0, c1, L, R, a0, u1, s_key, s_val);
  add_tap<C>(out, r1, c0, L, R, a1, u0, s_key, s_val);
  add_tap<C>(out, r1, c1, L, R, a1, u1, s_key, s_val);
  if (tap_w != nullptr) {
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const long long k = (long long)t * n + i;
      add_tap<C>(out, in ? __ldg(tap_row + k) : -1, in ? __ldg(tap_col + k) : -1,
                 L, R, in ? __ldg(tap_w + k) : 0.f, gv, s_key, s_val);
    }
  }
  // the block's table, flushed to device memory once
  __syncthreads();
  for (int k = threadIdx.x; k < SLOTS; k += THREADS) {
    const int key = s_key[k];
    if (key < 0) continue;
#pragma unroll
    for (int c = 0; c < C; ++c) atomicAdd(out + (long long)key * C + c, s_val[k * C + c]);
  }
}

template <int C>
void launch(const float* g, long long n, const int* tap_row,
            const int* tap_col, const float* tap_w, const int* sep_r0,
            const int* sep_r1, const int* sep_c0, const int* sep_c1,
            const float* sep_wr, const float* sep_wc, const float* sep_m,
            int L, float* out, cudaStream_t stream) {
  const long long blocks = (n + THREADS - 1) / THREADS;
  cubemap_accum_kernel<C><<<(unsigned)blocks, THREADS, 0, stream>>>(
      g, n, tap_row, tap_col, tap_w, sep_r0, sep_r1, sep_c0, sep_c1, sep_wr,
      sep_wc, sep_m, L, out);
}

}  // namespace

// g [n, C] f32; tap_row/tap_col [4, n] i32; tap_w [4, n] f32 (all three
// null when every pixel is separable); sep_* [n];
// out [6*L*L, C] f32, zeroed by the caller. C <= 8. Launches on `stream` and
// returns cudaGetLastError().
extern "C" int cubemap_accum(const float* g, long long n, const int* tap_row,
                             const int* tap_col, const float* tap_w,
                             const int* sep_r0, const int* sep_r1,
                             const int* sep_c0, const int* sep_c1,
                             const float* sep_wr, const float* sep_wc,
                             const float* sep_m, int L, int C, float* out,
                             void* stream) {
  if (n <= 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
#define CUBEMAP_CASE(K)                                                   \
  case K:                                                                 \
    launch<K>(g, n, tap_row, tap_col, tap_w, sep_r0, sep_r1, sep_c0,      \
              sep_c1, sep_wr, sep_wc, sep_m, L, out, s);                  \
    break;
  switch (C) {
    CUBEMAP_CASE(1)
    CUBEMAP_CASE(2)
    CUBEMAP_CASE(3)
    CUBEMAP_CASE(4)
    CUBEMAP_CASE(5)
    CUBEMAP_CASE(6)
    CUBEMAP_CASE(7)
    CUBEMAP_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef CUBEMAP_CASE
  return (int)cudaGetLastError();
}

extern "C" const char* cubemap_accum_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
