// Tile-blend forward for Hopper (sm_90a): front-to-back 2DGS surfel
// compositing of each 16x16 tile.
//
// Replaces the TPU kernel tpu_splat/kernels/tile_blend.py:tile_blend_forward
// (body _tile_blend_kernel). The TPU version's MXU one-hot matmuls, DMA
// rings, cross-tile head prefetch and [8, CI] wmax slabs are TPU workarounds;
// this kernel keeps only what they compute.
//
// Design: one block per tile, 256 threads, one pixel each. The tile's
// instance range is walked in chunks of CI=128. For each chunk, 128 threads
// read one instance's feature column each (the slab is feature-major, so
// every row read is a coalesced 512 B line), derive its recentered
// ray-splat coefficients once (as _geom_rows), and park them in shared
// memory; then every pixel thread walks the chunk's instances in order.
// Transmittance keeps the JAX chunk semantics (T_before = T_carry *
// exp(sum of earlier accepted log1p(-a)), contrib = accept & T_after >= 1e-4,
// done when T_carry * exp(sum over accepted) < 1e-4 at the chunk end), and
// the block leaves once every pixel is done (__syncthreads_and).
//
// Rounding: the per-instance coefficients are derived in double and rounded
// once, as the plain PyTorch version in kernels/tile_blend.py does (the
// cross products cancel, and a float32 derivation sits farther from the JAX
// reference than the tests allow). The p2 and depth-numerator fields are
// evaluated with explicit round-to-nearest products and sums, so they round
// as the plain version's: the depth of a near edge-on splat divides by a
// small p2, and a fused multiply-add there would move it. Everything else
// may be contracted into FMAs.
//
// Bound on this card: operations. Per (instance, pixel) pair the alpha test
// alone costs ~40 f32 operations, and the bench frame at 1088x1920 with 1M
// Gaussians tests ~0.55e9 pairs (after early termination), against
// ~0.37 GB of slab reads and image writes. The pair loop reads its coefficients as shared-memory broadcasts
// and runs the transmittance exps only for accepted pairs.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
// -fPIC (tpu_splat_torch/kernels/build.py). No --use_fast_math:
// the termination knife edge needs accurate expf/log1pf.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 16;
constexpr int NPIX = TILE * TILE;  // threads per block, one per pixel
constexpr int CI = 128;            // instances per chunk
constexpr int NWARP = NPIX / 32;

constexpr float NEAR_N = 0.2f;
constexpr float ALPHA_MIN = (float)(1.0 / 255.0);
constexpr float T_EPS = 1e-4f;
constexpr float FI = 2.0f;  // FILTER_INV_SQUARE
constexpr float LOG_AMAX = (float)-0.01005033585350145;  // log(0.99)
constexpr float M_C1 = (float)(100.0 / (100.0 - 0.2));
constexpr float M_C2 = (float)(100.0 / (100.0 - 0.2) * 0.2);

// out_px rows (tpu_splat/kernels/tile_blend.py O_*)
enum {
  O_COL = 0, O_T = 3, O_DEPTH = 4, O_REFL = 5, O_DIST = 6, O_NRM = 7,
  O_MED = 10, O_SCOPE = 11, O_NCON = 12, O_M1 = 13, O_M2 = 14, O_MEDRANK = 15
};

template <bool TRAIN, bool PACKED, bool WMAX>
__global__ void __launch_bounds__(NPIX)
tile_blend_fwd_kernel(const float* __restrict__ feats, long long n_cap,
                      const int* __restrict__ starts,
                      const int* __restrict__ counts,
                      const int* __restrict__ org_x,
                      const int* __restrict__ org_y,
                      float* __restrict__ out_px, float* __restrict__ wmax) {
  // per-instance coefficients of the current chunk
  __shared__ float4 s_g0[CI];  // A0, B0, cp0, A1
  __shared__ float4 s_g1[CI];  // B1, cp1, A2, B2
  __shared__ float4 s_g2[CI];  // cp2, da, db, dcc
  __shared__ float4 s_g3[CI];  // sx, sy, s0, lo
  __shared__ float s_tw2[CI];  // Tw.z (depth of an edge-on splat)
  __shared__ float4 s_c0[CI];  // colour 0..2, normal 0
  __shared__ float4 s_c1[CI];  // normal 1..2, refl, scope
  __shared__ unsigned s_wm[WMAX ? NWARP : 1][CI];

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int start = starts[t];
  const int count = counts[t];
  const float cxf = (float)(org_x[t] + 7);
  const float cyf = (float)(org_y[t] + 7);
  const float px = (float)((tid % TILE) - 7);
  const float py = (float)((tid / TILE) - 7);
  const float r2 = px * px + py * py;

  float T = 1.f;
  bool done = false;
  float dep = 0.f, ncon = 0.f;
  float con[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float m1 = 0.f, m2 = 0.f, dist = 0.f, med = 0.f, medrank = 0.f;

  const int n_chunks = (count + CI - 1) / CI;
  for (int ci = 0; ci < n_chunks; ++ci) {
    const long long base = (long long)start + (long long)ci * CI;
    const int nvalid = min(CI, count - ci * CI);

    if (tid < nvalid) {
      const float* f = feats + base + tid;
      double r[12];
#pragma unroll
      for (int k = 0; k < 12; ++k) r[k] = (double)__ldg(f + (long long)k * n_cap);
      const double cx = (double)cxf, cy = (double)cyf;
      const double Tu0 = r[0], Tu1 = r[1], Tu2 = r[2];
      const double Tv0 = r[3], Tv1 = r[4], Tv2 = r[5];
      const double Tw0 = r[6], Tw1 = r[7], Tw2 = r[8];
      // p = x*A + y*B + C with A = Tv x Tw, B = Tw x Tu, C = Tu x Tv
      const double A0 = Tv1 * Tw2 - Tv2 * Tw1;
      const double A1 = Tv2 * Tw0 - Tv0 * Tw2;
      const double A2 = Tv0 * Tw1 - Tv1 * Tw0;
      const double B0 = Tw1 * Tu2 - Tw2 * Tu1;
      const double B1 = Tw2 * Tu0 - Tw0 * Tu2;
      const double B2 = Tw0 * Tu1 - Tw1 * Tu0;
      const double C0 = Tu1 * Tv2 - Tu2 * Tv1;
      const double C1 = Tu2 * Tv0 - Tu0 * Tv2;
      const double C2 = Tu0 * Tv1 - Tu1 * Tv0;
      // recentered at the tile centre (org + 7)
      const double cp0 = C0 + cx * A0 + cy * B0;
      const double cp1 = C1 + cx * A1 + cy * B1;
      const double cp2 = C2 + cx * A2 + cy * B2;
      const double da = A0 * Tw0 + A1 * Tw1 + A2 * Tw2;
      const double db = B0 * Tw0 + B1 * Tw1 + B2 * Tw2;
      const double dc = C0 * Tw0 + C1 * Tw1 + C2 * Tw2;
      const double dcc = dc + cx * da + cy * db;
      // low-pass exponent s2 = -FI/2 (x^2+y^2) + sx x + sy y + s0
      const double lo = r[11];
      const double sx = r[9] - (double)FI * cx;
      const double sy = r[10] - (double)FI * cy;
      const double s0 = lo - (sx * sx + sy * sy) * (0.5 / (double)FI);
      s_g0[tid] = make_float4((float)A0, (float)B0, (float)cp0, (float)A1);
      s_g1[tid] = make_float4((float)B1, (float)cp1, (float)A2, (float)B2);
      s_g2[tid] = make_float4((float)cp2, (float)da, (float)db, (float)dcc);
      s_g3[tid] = make_float4((float)sx, (float)sy, (float)s0, (float)lo);
      s_tw2[tid] = (float)Tw2;  // exact: read as a float
      float c[8];
      if (PACKED) {
        // rows 12..15 hold bf16 pairs (c[k] high half, c[k+4] low half)
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const unsigned u = __float_as_uint(__ldg(f + (long long)(12 + k) * n_cap));
          c[k] = __uint_as_float(u & 0xFFFF0000u);
          c[k + 4] = __uint_as_float(u << 16);
        }
      } else {
#pragma unroll
        for (int k = 0; k < 8; ++k) c[k] = __ldg(f + (long long)(12 + k) * n_cap);
      }
      s_c0[tid] = make_float4(c[0], c[1], c[2], c[3]);
      s_c1[tid] = make_float4(c[4], c[5], c[6], c[7]);
    }
    __syncthreads();

    // chunk-local sums of log T over accepted (S) and contributing (Scon)
    float S = 0.f, Scon = 0.f;
    float cdep = 0.f, cdist = 0.f, P1 = 0.f, P2 = 0.f;
    float ccon[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int i = 0; i < nvalid; ++i) {
      float w = 0.f;
      if (!done) {
        const float4 g0 = s_g0[i], g1 = s_g1[i], g2 = s_g2[i], g3 = s_g3[i];
        // p0/p1 stay linear forms squared per pixel (tile_blend.py:296-300)
        const float p0 = g0.x * px + g0.y * py + g0.z;
        const float p1 = g0.w * px + g1.x * py + g1.y;
        // no FMA contraction: p2 and dn round as the plain version's
        const float p2 =
            __fadd_rn(__fadd_rn(__fmul_rn(g1.z, px), __fmul_rn(g1.w, py)), g2.x);
        const float dn =
            __fadd_rn(__fadd_rn(__fmul_rn(g2.y, px), __fmul_rn(g2.z, py)), g2.w);
        const float s2 = (g3.x * px + g3.y * py + g3.z) - (0.5f * FI) * r2;
        const bool unstable = fabsf(p2) < 1e-4f;
        const float ivp = 1.f / (unstable ? 1.f : p2);
        const float ivp2 = ivp * ivp;
        const float r3h = 0.5f * (p0 * p0 + p1 * p1) * ivp2;
        const float s3 = unstable ? -1e8f : g3.w - r3h;
        const float alpha = expf(fminf(LOG_AMAX, fmaxf(s3, s2)));
        const float depth = unstable ? s_tw2[i] : dn * ivp;
        if (depth >= NEAR_N && alpha >= ALPHA_MIN) {
          const float u = log1pf(-alpha);
          const float Tb = T * expf(S);
          const float Ta = Tb * (1.f - alpha);
          S += u;
          if (Ta >= T_EPS) {
            w = alpha * Tb;
            Scon += u;
            const float rank = (float)(ci * CI + i + 1);
            cdep += w * depth;
            const float4 c0 = s_c0[i], c1 = s_c1[i];
            ccon[0] += c0.x * w; ccon[1] += c0.y * w;
            ccon[2] += c0.z * w; ccon[3] += c0.w * w;
            ccon[4] += c1.x * w; ccon[5] += c1.y * w;
            ccon[6] += c1.z * w; ccon[7] += c1.w * w;
            if (!TRAIN) {
              // depth distortion (2DGS appendix; forward.cu:419-427)
              const float m = M_C1 - M_C2 * (1.f / fmaxf(depth, NEAR_N));
              const float mw = m * w;
              const float M1c = m1 + P1;
              const float M2c = m2 + P2;
              cdist += (m * m * (1.f - Tb) + M2c - 2.f * m * M1c) * w;
              P1 += mw;
              P2 += m * mw;
              if (Tb > 0.5f) {
                med = depth;
                medrank = rank;
              }
            }
            ncon = rank;
          }
        }
      }
      if (WMAX) {
        // w >= 0, so its bits order as unsigned ints
        const unsigned m = __reduce_max_sync(0xffffffffu, __float_as_uint(w));
        if ((tid & 31) == 0) s_wm[tid >> 5][i] = m;
      }
    }

    const float T_all = T * expf(S);
    T = T * expf(Scon);
    done = done || (T_all < T_EPS);
    dep += cdep;
#pragma unroll
    for (int k = 0; k < 8; ++k) con[k] += ccon[k];
    if (!TRAIN) {
      m1 += P1;
      m2 += P2;
      dist += cdist;
    }
    if (WMAX) {
      __syncthreads();
      if (tid < nvalid) {
        unsigned m = s_wm[0][tid];
#pragma unroll
        for (int k = 1; k < NWARP; ++k) m = max(m, s_wm[k][tid]);
        // a tile's slots are its own: no other block writes them
        wmax[base + tid] = __uint_as_float(m);
      }
    }
    // also the barrier before the next chunk overwrites shared memory
    if (__syncthreads_and(done)) break;
  }

  float* o = out_px + (long long)t * 16 * NPIX + tid;
  o[(O_COL + 0) * NPIX] = con[0];
  o[(O_COL + 1) * NPIX] = con[1];
  o[(O_COL + 2) * NPIX] = con[2];
  o[O_T * NPIX] = T;
  o[O_DEPTH * NPIX] = dep;
  o[O_REFL * NPIX] = con[6];
  o[O_DIST * NPIX] = dist;
  o[(O_NRM + 0) * NPIX] = con[3];
  o[(O_NRM + 1) * NPIX] = con[4];
  o[(O_NRM + 2) * NPIX] = con[5];
  o[O_MED * NPIX] = med;
  o[O_SCOPE * NPIX] = con[7] > 0.f ? 1.f : 0.f;
  o[O_NCON * NPIX] = ncon;
  o[O_M1 * NPIX] = m1;
  o[O_M2 * NPIX] = m2;
  o[O_MEDRANK * NPIX] = medrank;
}

template <bool TRAIN, bool PACKED, bool WMAX>
cudaError_t launch(const float* feats, long long n_cap, const int* starts,
                   const int* counts, const int* org_x, const int* org_y,
                   int n_tiles, float* out_px, float* wmax,
                   cudaStream_t stream) {
  tile_blend_fwd_kernel<TRAIN, PACKED, WMAX><<<n_tiles, NPIX, 0, stream>>>(
      feats, n_cap, starts, counts, org_x, org_y, out_px, wmax);
  return cudaGetLastError();
}

template <bool TRAIN, bool PACKED>
cudaError_t launch_w(bool wm, const float* feats, long long n_cap,
                     const int* starts, const int* counts, const int* org_x,
                     const int* org_y, int n_tiles, float* out_px,
                     float* wmax, cudaStream_t stream) {
  return wm ? launch<TRAIN, PACKED, true>(feats, n_cap, starts, counts, org_x,
                                          org_y, n_tiles, out_px, wmax, stream)
            : launch<TRAIN, PACKED, false>(feats, n_cap, starts, counts, org_x,
                                           org_y, n_tiles, out_px, wmax, stream);
}

}  // namespace

// feats [16 | 24, n_cap] f32 (row stride n_cap); starts/counts/org_x/org_y
// [n_tiles] i32; out_px [n_tiles, 16, 256] f32; wmax [n_cap] f32, zeroed by
// the caller. Launches on `stream` and returns cudaGetLastError().
extern "C" int tile_blend_fwd(const float* feats, long long n_cap,
                              const int* starts, const int* counts,
                              const int* org_x, const int* org_y, int n_tiles,
                              float* out_px, float* wmax, int train_shape,
                              int packed_feats, int collect_wmax,
                              void* stream) {
  if (n_tiles <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const bool wm = collect_wmax != 0;
  cudaError_t err;
  if (train_shape) {
    err = packed_feats
              ? launch_w<true, true>(wm, feats, n_cap, starts, counts, org_x,
                                     org_y, n_tiles, out_px, wmax, s)
              : launch_w<true, false>(wm, feats, n_cap, starts, counts, org_x,
                                      org_y, n_tiles, out_px, wmax, s);
  } else {
    err = packed_feats
              ? launch_w<false, true>(wm, feats, n_cap, starts, counts, org_x,
                                      org_y, n_tiles, out_px, wmax, s)
              : launch_w<false, false>(wm, feats, n_cap, starts, counts, org_x,
                                       org_y, n_tiles, out_px, wmax, s);
  }
  return (int)err;
}

extern "C" const char* tile_blend_fwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
