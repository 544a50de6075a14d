// Tile-blend forward for Hopper (sm_90a): front-to-back 2DGS surfel
// compositing of each 16x16 tile.
//
// Replaces the TPU kernel tpu_splat/kernels/tile_blend.py:tile_blend_forward
// (body _tile_blend_kernel). The TPU version's MXU one-hot matmuls, DMA
// rings, cross-tile head prefetch and [8, CI] wmax slabs are TPU workarounds;
// this kernel keeps only what they compute.
//
// Semantics: one block per tile, 256 threads, one pixel each; warp w holds
// an 8x4 block of the tile's pixels. The tile's instance range is walked in
// chunks of CI=128. For each chunk the per-instance ray-splat coefficients
// are derived once (as _geom_rows) and parked in shared memory; then every
// pixel thread walks the chunk's instances in order. Transmittance keeps the
// JAX chunk semantics (T_before = T_carry * exp(sum of earlier accepted
// log1p(-a)), contrib = accept & T_after >= 1e-4, done when T_carry *
// exp(sum over accepted) < 1e-4 at the chunk end), and the block leaves once
// every pixel is done.
//
// Rounding: the per-instance coefficients are derived in double and rounded
// once, as the plain PyTorch version in kernels/tile_blend.py does (the
// cross products cancel, and a float32 derivation sits farther from the JAX
// reference than the tests allow). The p2 and depth-numerator fields are
// evaluated with explicit round-to-nearest products and sums, so they round
// as the plain version's: the depth of a near edge-on splat divides by a
// small p2, and a fused multiply-add there would move it. Everything else
// may be contracted into FMAs. The per-pixel test is the first design's
// expression for expression, so out_px and wmax keep its bits.
//
// What bounds it on this card: instruction issue. The bound counts ~40 f32
// operations per live (instance, pixel) alpha test; the kernel issues ~130
// warp instructions for each (instance, warp) pair it visits (the divide
// for 1/p2 and an accurate expf, and where a lane accepts, log1pf and a
// second expf), and its four blocks an SM keep the schedulers busy: in
// kernel_ab.py's profile build each warp spends ~8 x 130 SM cycles on a
// pair (H100 80GB HBM3, 700 W). The first design visited every pair of a
// tile's walk, and in most of them no lane passes the alpha test. This one
// visits only the pairs that can pass:
//
// - It culls (instance, warp) pairs exactly, once per chunk. alpha = expf(
//   min(log 0.99, max(s3, s2))) passes only if its exponent reaches
//   log(1/255). While deriving an instance, the block bounds both exponents
//   over each warp's pixel block in float, from the float coefficients the
//   pixels use: s2 is a concave quadratic in (x, y), and s3 = lo - (p0^2 +
//   p1^2) / (2 p2^2) stays below E = log(1/255) - 2^-10 wherever Q = p0^2 +
//   p1^2 - K p2^2 >= Err, K = 2 (lo - E)(1 + 2^-17); on a pixel row Q is a
//   quadratic in x, minimised over the block's columns. The pixels' float
//   linear forms lie within 2^-21 M_k of the exact ones (M_k = 8|a_k| +
//   8|b_k| + |c_k|), which moves Q by at most 2^-20 S (S = M0^2 + M1^2 +
//   K M2^2); the bound's own float evaluation errs by less than 2^-17 S;
//   Err = 2^-12 S covers both. The pixels' float divide, square and
//   products of s3 round by a few 2^-24, inside the slack of K, and s2's
//   bound gets 2^-16 of its terms' magnitudes. A culled pair's exponent is
//   then below E + 1e-6 at every pixel of the block, and expf of that is
//   below (1/255)(1 - 9e-4) < ALPHA_MIN (expf is within 2 ulp): the pair
//   would be rejected, so skipping it moves no bit. lo <= E needs no bound
//   on s3 (s3 <= lo); bounds of 1e14 or more (near overflow, or |p2| where
//   1/p2^2 would be subnormal) and non-finite ones never cull. Each warp
//   ballots its bits of the chunk into four words and visits the set ones.
//   8x4 blocks meet fewer footprints than rows of 16x2 pixels.
// - A warp whose 32 pixels are all done skips its chunks' pair loops; the
//   block leaves as before.
// - The chunks are pipelined: chunk c+2's raw rows are copied with
//   cp.async into a second buffer while chunk c is blended, and chunk
//   c+1's coefficients and cull bits are derived into the other half of a
//   double buffer at the start of chunk c (all 256 threads: two per
//   instance, four warps' bits each), so one barrier a chunk remains.
// - wmax takes one atomicMax (on the float's bits, w >= 0) per (instance,
//   warp) that holds a contributor, instead of a block reduction through
//   shared memory.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
// -fPIC (tpu_splat_torch/kernels/build.py). No --use_fast_math:
// the termination knife edge needs accurate expf/log1pf. Ablations for
// kernel_ab.py: -DFWD_CULL=0 (every warp visits every instance),
// -DFWD_WARP_EXIT=0, -DFWD_MIN_BLOCKS=n, -DFWD_WARP_COLS=16 or 4 (warps on
// 16x2 or 4x8 pixels), -DFWD_PROFILE=1 (cycle counters).

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef FWD_CULL
#define FWD_CULL 1
#endif
#ifndef FWD_WARP_EXIT
#define FWD_WARP_EXIT 1
#endif
#ifndef FWD_MIN_BLOCKS
#define FWD_MIN_BLOCKS 4
#endif
#ifndef FWD_WARP_COLS
#define FWD_WARP_COLS 8
#endif
#ifndef FWD_PROFILE
#define FWD_PROFILE 0
#endif

namespace {

constexpr int TILE = 16;
constexpr int NPIX = TILE * TILE;  // threads per block, one per pixel
constexpr int CI = 128;            // instances per chunk
constexpr int WCOLS = FWD_WARP_COLS;  // a warp's pixel block: WCOLS x WROWS
constexpr int WROWS = 32 / WCOLS;
static_assert(WCOLS == 16 || WCOLS == 8 || WCOLS == 4, "FWD_WARP_COLS: 16, 8 or 4");
constexpr unsigned FULL = 0xffffffffu;

constexpr float NEAR_N = 0.2f;
constexpr float ALPHA_MIN = (float)(1.0 / 255.0);
constexpr float T_EPS = 1e-4f;
constexpr float FI = 2.0f;  // FILTER_INV_SQUARE
constexpr float LOG_AMAX = (float)-0.01005033585350145;  // log(0.99)
constexpr float M_C1 = (float)(100.0 / (100.0 - 0.2));
constexpr float M_C2 = (float)(100.0 / (100.0 - 0.2) * 0.2);
// the cull's exponent bound log(1/255) - 2^-10, and its slacks
constexpr float E_CULL = (float)(-5.541263545158426 - 1.0 / 1024.0);
constexpr float CULL_K_SLACK = 1.0f + 1.0f / (1 << 17);
constexpr float CULL_Q_SLACK = 1.0f / (1 << 12);
constexpr float CULL_S2_SLACK = 1.0f / (1 << 16);

// out_px rows (tpu_splat/kernels/tile_blend.py O_*)
enum {
  O_COL = 0, O_T = 3, O_DEPTH = 4, O_REFL = 5, O_DIST = 6, O_NRM = 7,
  O_MED = 10, O_SCOPE = 11, O_NCON = 12, O_M1 = 13, O_M2 = 14, O_MEDRANK = 15
};

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

#if FWD_PROFILE
// kernel_ab.py's profile build: SM cycles each warp spends deriving, in its
// pair loops and at the chunk ends (barrier included), and the pair
// iterations it runs and those in which a lane accepts, summed over warps
__device__ unsigned long long fwd_prof[5];
#endif

// one chunk's per-instance coefficients
struct Coefs {
  float4 g0[CI];   // A0, B0, cp0, A1
  float4 g1[CI];   // B1, cp1, A2, B2
  float4 g2[CI];   // cp2, da, db, dcc
  float4 g3[CI];   // sx, sy, s0, lo
  float tw2[CI];   // Tw.z (depth of an edge-on splat)
  float4 c0[CI];   // colour 0..2, normal 0
  float4 c1[CI];   // normal 1..2, refl, scope
  unsigned char visit[2][CI];  // bit w & 3 of [w >> 2]: warp w must visit it
};

// min over x in [lo, hi] of a x^2 + b x + c; inv2a = 1 / (2a), used when a > 0
__device__ __forceinline__ float quad_min(float a, float inv2a, float b, float c, float lo,
                                          float hi) {
  float m = fminf((a * lo + b) * lo + c, (a * hi + b) * hi + c);
  const float xv = -b * inv2a;
  if (a > 0.f && xv > lo && xv < hi) m = fminf(m, (a * xv + b) * xv + c);
  return m;
}

// Derive instance `i`'s coefficients from its raw rows r[0..NROW) into s
// (when `store`), and the visit bits of warps half*4 .. half*4+3.
template <bool PACKED>
__device__ __forceinline__ void derive(const float* r, double cx, double cy, Coefs& s, int i,
                                       bool store, int half) {
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
  // low-pass exponent s2 = -FI/2 (x^2+y^2) + sx x + sy y + s0
  const double lo = r[11];
  const double sx = r[9] - (double)FI * cx;
  const double sy = r[10] - (double)FI * cy;
  const double s0 = lo - (sx * sx + sy * sy) * (0.5 / (double)FI);
  if (store) {
    const double da = A0 * Tw0 + A1 * Tw1 + A2 * Tw2;
    const double db = B0 * Tw0 + B1 * Tw1 + B2 * Tw2;
    const double dc = C0 * Tw0 + C1 * Tw1 + C2 * Tw2;
    const double dcc = dc + cx * da + cy * db;
    s.g0[i] = make_float4((float)A0, (float)B0, (float)cp0, (float)A1);
    s.g1[i] = make_float4((float)B1, (float)cp1, (float)A2, (float)B2);
    s.g2[i] = make_float4((float)cp2, (float)da, (float)db, (float)dcc);
    s.g3[i] = make_float4((float)sx, (float)sy, (float)s0, (float)lo);
    s.tw2[i] = r[8];  // exact: read as a float
    float c[8];
    if (PACKED) {
      // rows 12..15 hold bf16 pairs (c[k] high half, c[k+4] low half)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const unsigned u = __float_as_uint(r[12 + k]);
        c[k] = __uint_as_float(u & 0xFFFF0000u);
        c[k + 4] = __uint_as_float(u << 16);
      }
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) c[k] = r[12 + k];
    }
    s.c0[i] = make_float4(c[0], c[1], c[2], c[3]);
    s.c1[i] = make_float4(c[4], c[5], c[6], c[7]);
  }
  unsigned bits = 0xFu;
  if (FWD_CULL) {
    // the float coefficients the pixels use
    const float a0 = (float)A0, a1 = (float)A1, a2 = (float)A2;
    const float b0 = (float)B0, b1 = (float)B1, b2 = (float)B2;
    const float c0 = (float)cp0, c1 = (float)cp1, c2 = (float)cp2;
    const float fsx = (float)sx, fsy = (float)sy, fs0 = (float)s0, flo = (float)lo;
    const float M0 = 8.f * fabsf(a0) + 8.f * fabsf(b0) + fabsf(c0);
    const float M1 = 8.f * fabsf(a1) + 8.f * fabsf(b1) + fabsf(c1);
    const float M2 = 8.f * fabsf(a2) + 8.f * fabsf(b2) + fabsf(c2);
    const float d = flo - E_CULL;  // its sign is exact
    const float K = d > 0.f ? 2.f * d * CULL_K_SLACK : 0.f;
    const float err_q = CULL_Q_SLACK * (M0 * M0 + M1 * M1 + K * M2 * M2);
    const float err_s2 =
        CULL_S2_SLACK * (8.f * fabsf(fsx) + 8.f * fabsf(fsy) + fabsf(fs0) + 128.f);
    // Q on row y is qa x^2 + (qb0 + qb1 y) x + (qc0 + qc1 y + qc2 y^2), with
    // L_k = a_k x + b_k y + c_k and Q = L0^2 + L1^2 - K L2^2
    const float qa = a0 * a0 + a1 * a1 - K * a2 * a2;
    const float inv2a = 0.5f / qa;
    const float qb1 = 2.f * (a0 * b0 + a1 * b1 - K * a2 * b2);
    const float qb0 = 2.f * (a0 * c0 + a1 * c1 - K * a2 * c2);
    const float qc2 = b0 * b0 + b1 * b1 - K * b2 * b2;
    const float qc1 = 2.f * (b0 * c0 + b1 * c1 - K * b2 * c2);
    const float qc0 = c0 * c0 + c1 * c1 - K * c2 * c2;
    // every bound finite and far from overflow (a comparison with NaN is
    // false); M2 < 1e14 also keeps 1/p2^2 normal
    const bool finite = M0 < 1e14f && M1 < 1e14f && M2 < 1e14f && K < 1e3f && err_s2 < 1e30f;
    bits = 0u;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      // warp w's pixels: columns x0 .. x0 + WCOLS - 1, rows y0 .. y0 + WROWS - 1
      const int w = half * 4 + k;
      const float x0 = (float)((w % (TILE / WCOLS)) * WCOLS - 7), x1 = x0 + (WCOLS - 1);
      const int y0 = (w / (TILE / WCOLS)) * WROWS - 7;
      // s2 on a row peaks at x = sx / 2 (clamped to the row)
      const float xs = fminf(x1, fmaxf(x0, 0.5f * fsx));
      const float s2x = fsx * xs - xs * xs + fs0 + err_s2;
      bool cull = finite;
#pragma unroll
      for (int dy = 0; dy < WROWS; ++dy) {
        const float y = (float)(y0 + dy);
        cull = cull && (s2x + fsy * y - y * y <= E_CULL);
        if (d > 0.f)
          cull = cull && quad_min(qa, inv2a, qb0 + qb1 * y, qc0 + y * (qc1 + qc2 * y), x0, x1) >=
                             err_q;
      }
      if (!cull) bits |= 1u << k;
    }
  }
  s.visit[half][i] = (unsigned char)bits;
}

template <bool TRAIN, bool PACKED, bool WMAX>
__global__ void __launch_bounds__(NPIX, FWD_MIN_BLOCKS)
tile_blend_fwd_kernel(const float* __restrict__ feats, long long n_cap,
                      const int* __restrict__ starts,
                      const int* __restrict__ counts,
                      const int* __restrict__ org_x,
                      const int* __restrict__ org_y,
                      float* __restrict__ out_px, float* __restrict__ wmax) {
  constexpr int NROW = PACKED ? 16 : 20;  // slab rows read: geometry + content
  __shared__ Coefs s_co[2];
  __shared__ float s_raw[2][NROW][CI];  // raw rows of the chunks ahead (cp.async)

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int inst = tid & (CI - 1), half = tid >> 7;  // the instance this thread derives
  const int start = starts[t];
  const int count = counts[t];
  const float cxf = (float)(org_x[t] + 7);
  const float cyf = (float)(org_y[t] + 7);
  const double cx = (double)cxf, cy = (double)cyf;
  // warp w blends a WCOLS x WROWS block of the tile's pixels
  const int pix = ((warp / (TILE / WCOLS)) * WROWS + lane / WCOLS) * TILE +
                  (warp % (TILE / WCOLS)) * WCOLS + lane % WCOLS;
  const float px = (float)((pix % TILE) - 7);
  const float py = (float)((pix / TILE) - 7);
  const float r2 = px * px + py * py;

  float T = 1.f;
  bool done = false;
  float dep = 0.f, ncon = 0.f;
  float con[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float m1 = 0.f, m2 = 0.f, dist = 0.f, med = 0.f, medrank = 0.f;

  const int n_chunks = (count + CI - 1) / CI;
  auto nvalid_of = [&](int ci) { return min(CI, count - ci * CI); };
  auto column = [&](int ci) { return feats + (long long)start + (long long)ci * CI + inst; };
  auto prefetch = [&](int ci) {  // chunk ci's raw column `inst`, by the first half
    if (ci < n_chunks && half == 0 && inst < nvalid_of(ci)) {
      const float* f = column(ci);
#pragma unroll
      for (int k = 0; k < NROW; ++k)
        cp_async4(&s_raw[ci & 1][k][inst], f + (long long)k * n_cap);
    }
  };
  auto derive_chunk = [&](int ci, const float* r) {
    if (inst < nvalid_of(ci)) {
      derive<PACKED>(r, cx, cy, s_co[ci & 1], inst, half == 0, half);
    } else {
      s_co[ci & 1].visit[half][inst] = 0;
    }
  };

  // chunk 0 straight from device memory while chunk 1 is copied
  prefetch(1);
  if (n_chunks > 0) {
    float r[NROW];
    if (inst < nvalid_of(0)) {
      const float* f = column(0);
#pragma unroll
      for (int k = 0; k < NROW; ++k) r[k] = __ldg(f + (long long)k * n_cap);
    }
    derive_chunk(0, r);
  }
  cp_async_wait_all();
  __syncthreads();

  unsigned long long prof[5] = {0, 0, 0, 0, 0};
  long long t_prof = FWD_PROFILE ? clock64() : 0;
  auto lap = [&](int k) {
    if (FWD_PROFILE) {
      const long long t_now = clock64();
      prof[k] += (unsigned long long)(t_now - t_prof);
      t_prof = t_now;
    }
  };
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int buf = ci & 1;
    // chunk ci+1's coefficients into the other buffer (last read by chunk
    // ci-1's loop, which ended before the barrier), from its raw rows
    // (complete at the barrier); then chunk ci+2's rows into the raw buffer
    // chunk ci's derivation read
    if (ci + 1 < n_chunks) {
      float r[NROW];
#pragma unroll
      for (int k = 0; k < NROW; ++k) r[k] = s_raw[buf ^ 1][k][inst];
      derive_chunk(ci + 1, r);
    }
    prefetch(ci + 2);
    lap(0);

    const Coefs& s = s_co[buf];
    // chunk-local sums of log T over accepted (S) and contributing (Scon)
    float S = 0.f, Scon = 0.f;
    float cdep = 0.f, cdist = 0.f, P1 = 0.f, P2 = 0.f;
    float ccon[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (!(FWD_WARP_EXIT && __all_sync(FULL, done))) {
      // the chunk's instances this warp visits, as four 32-bit words
      unsigned words[CI / 32];
#pragma unroll
      for (int j = 0; j < CI / 32; ++j)
        words[j] = __ballot_sync(FULL, (s.visit[warp >> 2][j * 32 + lane] >> (warp & 3)) & 1u);
#pragma unroll
      for (int j = 0; j < CI / 32; ++j) {
        unsigned todo = words[j];
        while (todo != 0u) {
          const int i = j * 32 + __ffs(todo) - 1;
          todo &= todo - 1u;
          float w = 0.f;
          bool acc = false;
          if (!done) {
            const float4 g0 = s.g0[i], g1 = s.g1[i], g2 = s.g2[i], g3 = s.g3[i];
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
            const float depth = unstable ? s.tw2[i] : dn * ivp;
            if (depth >= NEAR_N && alpha >= ALPHA_MIN) {
              acc = true;
              const float u = log1pf(-alpha);
              const float Tb = T * expf(S);
              const float Ta = Tb * (1.f - alpha);
              S += u;
              if (Ta >= T_EPS) {
                w = alpha * Tb;
                Scon += u;
                const float rank = (float)(ci * CI + i + 1);
                cdep += w * depth;
                const float4 c0 = s.c0[i], c1 = s.c1[i];
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
          if (FWD_PROFILE) {
            prof[3] += 1;
            prof[4] += __any_sync(FULL, acc) ? 1 : 0;
          }
          if (WMAX) {
            // w >= 0, so its bits order as unsigned ints; a tile's slots
            // are its own, and the caller zeroed them
            const unsigned m = __reduce_max_sync(FULL, __float_as_uint(w));
            if (lane == 0 && m != 0u)
              atomicMax(reinterpret_cast<unsigned*>(wmax) + (long long)start + ci * CI + i, m);
          }
        }
      }
    }

    lap(1);
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
    // also publishes chunk ci+1's coefficients and chunk ci+2's rows
    cp_async_wait_all();
    const bool all_done = __syncthreads_and(done);
    lap(2);
    if (all_done) break;
  }
#if FWD_PROFILE
  if (lane == 0)
    for (int k = 0; k < 5; ++k) atomicAdd(&fwd_prof[k], prof[k]);
#endif
  // no copy may land after the block has left
  cp_async_wait_all();

  float* o = out_px + (long long)t * 16 * NPIX + pix;
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

// Ask for the largest shared-memory carveout once: four blocks of ~46 KB
// need 186 KB of the SM's 228 KB.
template <bool TRAIN, bool PACKED, bool WMAX>
cudaError_t prepare() {
  static cudaError_t err = cudaFuncSetAttribute(
      tile_blend_fwd_kernel<TRAIN, PACKED, WMAX>,
      cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
  return err;
}

template <bool TRAIN, bool PACKED, bool WMAX>
int blocks_per_sm() {
  int n = 0;
  cudaError_t err = prepare<TRAIN, PACKED, WMAX>();
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, tile_blend_fwd_kernel<TRAIN, PACKED, WMAX>, NPIX, 0);
  return err != cudaSuccess ? -(int)err : n;
}

template <bool TRAIN, bool PACKED, bool WMAX>
cudaError_t launch(const float* feats, long long n_cap, const int* starts,
                   const int* counts, const int* org_x, const int* org_y,
                   int n_tiles, float* out_px, float* wmax, cudaStream_t stream) {
  const cudaError_t err = prepare<TRAIN, PACKED, WMAX>();
  if (err != cudaSuccess) return err;
  tile_blend_fwd_kernel<TRAIN, PACKED, WMAX><<<n_tiles, NPIX, 0, stream>>>(
      feats, n_cap, starts, counts, org_x, org_y, out_px, wmax);
  return cudaGetLastError();
}

template <bool TRAIN, bool PACKED>
cudaError_t launch_w(bool wm, const float* feats, long long n_cap,
                     const int* starts, const int* counts, const int* org_x,
                     const int* org_y, int n_tiles, float* out_px, float* wmax,
                     cudaStream_t stream) {
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

// Blocks of the (train_shape, packed_feats, collect_wmax) variant that fit
// on one SM, after prepare(); < 0 is a CUDA error.
extern "C" int tile_blend_fwd_blocks_per_sm(int train_shape, int packed_feats,
                                            int collect_wmax) {
  const bool t = train_shape != 0, p = packed_feats != 0, w = collect_wmax != 0;
  return t ? (p ? (w ? blocks_per_sm<true, true, true>() : blocks_per_sm<true, true, false>())
                : (w ? blocks_per_sm<true, false, true>() : blocks_per_sm<true, false, false>()))
           : (p ? (w ? blocks_per_sm<false, true, true>() : blocks_per_sm<false, true, false>())
                : (w ? blocks_per_sm<false, false, true>()
                     : blocks_per_sm<false, false, false>()));
}

#if FWD_PROFILE
// Copy the profile counters (5 words) to `out` and zero them.
extern "C" int tile_blend_fwd_profile(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, fwd_prof, sizeof(fwd_prof));
  if (err == cudaSuccess) {
    const unsigned long long zero[5] = {0, 0, 0, 0, 0};
    err = cudaMemcpyToSymbol(fwd_prof, zero, sizeof(zero));
  }
  return (int)err;
}
#endif

extern "C" const char* tile_blend_fwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
