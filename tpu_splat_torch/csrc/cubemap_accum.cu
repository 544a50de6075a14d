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
// Design: one thread per pixel. A separable pixel (sep_m != 0; every pixel
// of the seamless filter, which samples EdgeTable-padded faces) adds its
// 2x2 bilinear taps: rows r0/r1 with weights (1-wr)*m / wr*m times columns
// c0/c1 with weights (1-wc) / wc, as the TPU kernel's separable product.
// Every pixel also adds its 4 stored generic taps (tap_w, zero for separable
// pixels by the caller's contract; the seam and corner cases of the generic
// filter). A caller whose pixels are all separable passes null tap arrays,
// and the kernel then reads only the separable records. Taps outside [0, 6L) x [0, L) add nothing, as the one-hot
// membership there matches no texel. Sums go through float atomics, so
// their order changes from run to run: against the plain version the result
// differs by float32 rounding of the per-texel sums (the tests allow 1e-5 of
// the largest |d_tex|).
//
// Bound on this card: bytes, at the bench frame: it reads the pixel records
// (g and the separable indices and weights: 10 words a pixel) once and
// writes the texture gradient once. Neighbouring pixels of a smooth
// reflection map hit the same texels, so the atomics contend; the tile-major
// pixel order of the caller keeps a warp's taps close. On one H100 (700 W)
// at the bench frame it takes ~0.57 ms against ~0.23 ms for one index_add_
// of the weighted taps (PERF.md); a channel count fixed at compile time,
// which keeps gv/u0/u1 out of local memory, did not change that.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
// -fPIC (tpu_splat_torch/kernels/build.py).

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_C = 8;

__device__ __forceinline__ void add_tap(float* __restrict__ out, int row,
                                        int col, int L, int C, int R,
                                        float w, const float* gv) {
  if (w == 0.f || row < 0 || row >= R || col < 0 || col >= L) return;
  float* o = out + ((long long)row * L + col) * C;
  for (int c = 0; c < C; ++c) atomicAdd(o + c, w * gv[c]);
}

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
                     const float* __restrict__ sep_m, int L, int C,
                     float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const int R = 6 * L;
  float gv[MAX_C];
  for (int c = 0; c < C; ++c) gv[c] = __ldg(g + i * C + c);
  const float m = __ldg(sep_m + i);
  if (m != 0.f) {
    const float wr = __ldg(sep_wr + i), wc = __ldg(sep_wc + i);
    const float a0 = (1.f - wr) * m, a1 = wr * m;
    const float b0 = 1.f - wc, b1 = wc;
    const int r0 = __ldg(sep_r0 + i), r1 = __ldg(sep_r1 + i);
    const int c0 = __ldg(sep_c0 + i), c1 = __ldg(sep_c1 + i);
    float u0[MAX_C], u1[MAX_C];
    for (int c = 0; c < C; ++c) {
      u0[c] = b0 * gv[c];
      u1[c] = b1 * gv[c];
    }
    add_tap(out, r0, c0, L, C, R, a0, u0);
    add_tap(out, r0, c1, L, C, R, a0, u1);
    add_tap(out, r1, c0, L, C, R, a1, u0);
    add_tap(out, r1, c1, L, C, R, a1, u1);
  }
  if (tap_w == nullptr) return;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const long long k = (long long)t * n + i;
    add_tap(out, __ldg(tap_row + k), __ldg(tap_col + k), L, C, R,
            __ldg(tap_w + k), gv);
  }
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
  if (C < 1 || C > MAX_C) return (int)cudaErrorInvalidValue;
  const long long blocks = (n + THREADS - 1) / THREADS;
  cubemap_accum_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      g, n, tap_row, tap_col, tap_w, sep_r0, sep_r1, sep_c0, sep_c1, sep_wr,
      sep_wc, sep_m, L, C, out);
  return (int)cudaGetLastError();
}

extern "C" const char* cubemap_accum_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
