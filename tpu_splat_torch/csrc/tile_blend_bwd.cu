// Tile-blend backward for Hopper (sm_90a): back-to-front sweep of each
// 16x16 tile that rebuilds transmittance and writes the per-instance
// gradients of the raw attribute rows.
//
// Replaces the TPU kernel tpu_splat/kernels/tile_blend.py:
// tile_blend_backward (body of _make_bwd_kernel). The TPU version's
// triangular suffix-sum matmuls, 3-pass bf16 pixel-basis projections, DMA
// rings and cross-tile head prefetch are TPU workarounds; this kernel keeps
// only what they compute: the hand-derived reverse of the forward sweep
// (the TPU counterpart of backward.cu renderCUDA:143-470).
//
// Design: one block per tile, 256 threads, one pixel each, as the forward
// (csrc/tile_blend_fwd.cu). The tile's `used` chunks (those holding a
// contributor of some pixel, from the forward's n_contrib) are walked from
// the last to the first, 128 instances at a time. 128 threads derive a
// chunk's per-instance coefficients (in double, rounded once, exactly as the
// forward) into shared memory; then every pixel thread walks the chunk's
// instances back to front and evaluates each pair with the forward's own
// arithmetic, so the accept decisions are the forward's. Per pixel:
//   T_i    = T_rev * exp(sum of -log1p(-a_j) over contributors j >= i in
//            the chunk), T_rev carried from later chunks (starts at T_final)
//   B_i    = B_carry + sum over later contributors of what_j w_j
//            (- dist^ w_j m_j^2 T_j), B_carry starting at T^ * T_final
//   dL/da  = T_i what_i - B_i / (1 - a_i)
// then routed through the s3/s2 exponent branches (clamp gate s < log a_max
// -- PARITY.md D4; the 1e-4 edge-on guard -- D5; frozen-s depth gradients in
// the low-pass branch) to 26 per-pair field gradients: the x, y and constant
// projections of p0, p1, p2, dn and s2, the constants of s3 and Tw.z, the
// frozen-s Tw.x / Tw.y sums and the 7 content rows. Contributors are rebuilt
// from the forward's n_contrib rank (rank <= n_contrib and accepted); a
// pixel makes no alpha test for ranks past its n_contrib.
//
// Each instance lives in one tile only, so its gradient is a reduction over
// the block's 256 pixels, SUB instances at a time: per warp a transposed
// butterfly (below), then the warp partials summed in shared memory in a
// fixed warp order. One thread per instance then runs the coefficient-space
// chain (recentering, the dn dots, the cross-product VJPs) back to the raw
// rows and writes d_feats[:, i] once. No atomics: the regroup into
// per-Gaussian gradients runs after this kernel. full_grads adds the
// distortion / M1 / M2 / median chains; packed slabs read bf16-pair content
// rows and write the content gradients as round-to-nearest-even bf16 pairs
// (c[k] high half, c[k+4] low half).
//
// Bound on this card: operations. Every (instance, pixel) pair up to the
// pixel's n_contrib costs the forward's ~40-op alpha test; per contributing
// pair the reverse step adds ~70 f32 operations and its share of the 26
// per-instance sums; the slab, fwd_px, ct_px and d_feats bytes are 0.62 GB
// at the bench step.
//
// What held the first design back (8.3 ms against a 0.41 ms bound at the
// bench step): each (instance, warp) with a contributing lane summed its 26
// values with 26 xor-butterflies, 130 shuffles, and every (instance, warp)
// then had lane 0 store 26 partials (zeros when no lane contributed), all on
// the shared-memory pipe (7.6M of the 30M (instance, warp) pairs hold a
// contributor; a build whose reduction is one shuffle ran in 5.3 ms, and
// the pair arithmetic is most of the rest). The redesign keeps the pair arithmetic and cuts
// that pipe's work: the 26 values, padded to 32, go through one transposed
// butterfly (16 + 8 + 4 + 2 + 1 = 31 shuffles, after which lane k holds sum
// k), each lane stores its own sum, and a warp with no contributor stores
// only a zero flag, which the fixed-order sum over warps skips. The launch
// bound asks for three blocks an SM (80 registers; the first design's 107
// allowed two), and the warp partials of 64 instances a round take 53 KB
// of dynamic shared memory. BWD_SUB (instances a round) and BWD_MIN_BLOCKS
// (blocks an SM) are compile-time knobs that kernel_ab.py times.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
// -fPIC (tpu_splat_torch/kernels/build.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 16;
constexpr int NPIX = TILE * TILE;
constexpr int CI = 128;
constexpr int NWARP = NPIX / 32;
#ifndef BWD_SUB
#define BWD_SUB 64
#endif
#ifndef BWD_MIN_BLOCKS
#define BWD_MIN_BLOCKS 3
#endif
constexpr int SUB = BWD_SUB;  // instances per shared-memory reduction round
static_assert(CI % SUB == 0 && SUB <= NPIX, "SUB divides the chunk");
constexpr int NSUM = 26;
constexpr unsigned ALL_LANES = 0xffffffffu;
// s_part[NWARP][NSUM][SUB] in dynamic shared memory
constexpr int PART_BYTES = NWARP * NSUM * SUB * (int)sizeof(float);

constexpr float NEAR_N = 0.2f;
constexpr float ALPHA_MIN = (float)(1.0 / 255.0);
constexpr float FI = 2.0f;  // FILTER_INV_SQUARE
constexpr float LOG_AMAX = (float)-0.01005033585350145;  // log(0.99)
constexpr float M_C1 = (float)(100.0 / (100.0 - 0.2));
constexpr float M_C2 = (float)(100.0 / (100.0 - 0.2) * 0.2);

enum {
  O_COL = 0, O_T = 3, O_DEPTH = 4, O_REFL = 5, O_DIST = 6, O_NRM = 7,
  O_MED = 10, O_SCOPE = 11, O_NCON = 12, O_M1 = 13, O_M2 = 14, O_MEDRANK = 15
};

// per-pair sums: x, y and constant projections of p0, p1, p2, dn, s2, then
// the s3 and Tw.z constants, the frozen-s Tw.x/Tw.y sums, 7 content rows
enum {
  S_P0 = 0, S_P1 = 3, S_P2 = 6, S_DN = 9, S_S2 = 12, S_S3 = 15, S_TW2 = 16,
  S_LPX = 17, S_LPY = 18, S_CON = 19
};

struct Geom {
  double Tu[3], Tv[3], Tw[3], A[3], B[3], C[3];
  double cp[3], da, db, dcc, sx, sy, s0, lo;
};

// the forward's coefficient derivation (csrc/tile_blend_fwd.cu), in double
__device__ __forceinline__ void derive(const float* f, long long n_cap,
                                       double cx, double cy, Geom& q) {
  double r[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) r[k] = (double)__ldg(f + (long long)k * n_cap);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    q.Tu[k] = r[k];
    q.Tv[k] = r[3 + k];
    q.Tw[k] = r[6 + k];
  }
  q.A[0] = q.Tv[1] * q.Tw[2] - q.Tv[2] * q.Tw[1];
  q.A[1] = q.Tv[2] * q.Tw[0] - q.Tv[0] * q.Tw[2];
  q.A[2] = q.Tv[0] * q.Tw[1] - q.Tv[1] * q.Tw[0];
  q.B[0] = q.Tw[1] * q.Tu[2] - q.Tw[2] * q.Tu[1];
  q.B[1] = q.Tw[2] * q.Tu[0] - q.Tw[0] * q.Tu[2];
  q.B[2] = q.Tw[0] * q.Tu[1] - q.Tw[1] * q.Tu[0];
  q.C[0] = q.Tu[1] * q.Tv[2] - q.Tu[2] * q.Tv[1];
  q.C[1] = q.Tu[2] * q.Tv[0] - q.Tu[0] * q.Tv[2];
  q.C[2] = q.Tu[0] * q.Tv[1] - q.Tu[1] * q.Tv[0];
#pragma unroll
  for (int k = 0; k < 3; ++k) q.cp[k] = q.C[k] + cx * q.A[k] + cy * q.B[k];
  q.da = q.A[0] * q.Tw[0] + q.A[1] * q.Tw[1] + q.A[2] * q.Tw[2];
  q.db = q.B[0] * q.Tw[0] + q.B[1] * q.Tw[1] + q.B[2] * q.Tw[2];
  const double dc = q.C[0] * q.Tw[0] + q.C[1] * q.Tw[1] + q.C[2] * q.Tw[2];
  q.dcc = dc + cx * q.da + cy * q.db;
  q.lo = r[11];
  q.sx = r[9] - (double)FI * cx;
  q.sy = r[10] - (double)FI * cy;
  q.s0 = q.lo - (q.sx * q.sx + q.sy * q.sy) * (0.5 / (double)FI);
}

// One round of the transposed butterfly over v[0, 2*O): a lane keeps the
// half of the values its bit O selects and adds its xor-partner's copy of
// that half, which the partner sends in one shuffle a value.
template <int O>
__device__ __forceinline__ void transpose_round(float (&v)[32], bool hi) {
#pragma unroll
  for (int j = 0; j < O; ++j) {
    const float send = hi ? v[j] : v[j + O];
    const float keep = hi ? v[j + O] : v[j];
    v[j] = keep + __shfl_xor_sync(ALL_LANES, send, O);
  }
}

// Sum of v[k] over the warp's lanes for every k < 32, in 31 shuffles: lane
// k returns sum k.
__device__ __forceinline__ float transpose_sum(float (&v)[32], int lane) {
  transpose_round<16>(v, lane & 16);
  transpose_round<8>(v, lane & 8);
  transpose_round<4>(v, lane & 4);
  transpose_round<2>(v, lane & 2);
  transpose_round<1>(v, lane & 1);
  return v[0];
}

// bf16 round-to-nearest-even of two floats packed (a high | b low) into one
// float-bitcast word: kernels/tile_blend.py:_pack2_bits
__device__ __forceinline__ float pack2(float a, float b) {
  auto rne = [](float x) -> uint32_t {
    uint32_t u = __float_as_uint(x);
    if ((u & 0x7f800000u) == 0x7f800000u && (u & 0x007fffffu)) return u | 0x00400000u;
    return u + 0x7fffu + ((u >> 16) & 1u);
  };
  return __uint_as_float((rne(a) & 0xffff0000u) | (rne(b) >> 16));
}

template <bool FULL, bool PACKED>
__global__ void __launch_bounds__(NPIX, BWD_MIN_BLOCKS)
tile_blend_bwd_kernel(const float* __restrict__ feats, long long n_cap,
                      const int* __restrict__ starts,
                      const int* __restrict__ counts,
                      const int* __restrict__ used,
                      const int* __restrict__ org_x,
                      const int* __restrict__ org_y,
                      const float* __restrict__ fwd_px,
                      const float* __restrict__ ct_px,
                      float* __restrict__ d_feats) {
  __shared__ float4 s_g0[CI];  // A0, B0, cp0, A1
  __shared__ float4 s_g1[CI];  // B1, cp1, A2, B2
  __shared__ float4 s_g2[CI];  // cp2, da, db, dcc
  __shared__ float4 s_g3[CI];  // sx, sy, s0, lo
  __shared__ float s_tw2[CI];
  __shared__ float4 s_c0[CI];  // colour 0..2, normal 0
  __shared__ float4 s_c1[CI];  // normal 1..2, refl, (scope)
  __shared__ unsigned char s_has[NWARP][SUB];  // the warp stored sums
  extern __shared__ float s_dyn[];
  float(*s_part)[NSUM][SUB] = reinterpret_cast<float(*)[NSUM][SUB]>(s_dyn);

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int start = starts[t];
  const int count = counts[t];
  const int n_used = used[t];
  const float cxf = (float)(org_x[t] + 7);
  const float cyf = (float)(org_y[t] + 7);
  const float px = (float)((tid % TILE) - 7);
  const float py = (float)((tid / TILE) - 7);
  const float r2 = px * px + py * py;

  const float* fw = fwd_px + (long long)t * 16 * NPIX + tid;
  const float* ct = ct_px + (long long)t * 16 * NPIX + tid;
  const float T_final = fw[O_T * NPIX];
  const float ncon = fw[O_NCON * NPIX];
  const float ct_d = ct[O_DEPTH * NPIX];
  const float ct7[7] = {ct[(O_COL + 0) * NPIX], ct[(O_COL + 1) * NPIX],
                        ct[(O_COL + 2) * NPIX], ct[(O_NRM + 0) * NPIX],
                        ct[(O_NRM + 1) * NPIX], ct[(O_NRM + 2) * NPIX],
                        ct[O_REFL * NPIX]};
  float M1tot = 0.f, M2tot = 0.f, med_rank = 0.f, ct_dist = 0.f, ct_med = 0.f,
        ct_m1 = 0.f, ct_m2 = 0.f;
  if (FULL) {
    M1tot = fw[O_M1 * NPIX];
    M2tot = fw[O_M2 * NPIX];
    med_rank = fw[O_MEDRANK * NPIX];
    ct_dist = ct[O_DIST * NPIX];
    ct_med = ct[O_MED * NPIX];
    ct_m1 = ct[O_M1 * NPIX];
    ct_m2 = ct[O_M2 * NPIX];
  }

  // reverse carries from later chunks
  float T_rev = T_final;
  float Bc = ct[O_T * NPIX] * T_final;
  float Wsuf = 0.f, MWsuf = 0.f, M2Wsuf = 0.f;

  for (int ci = n_used - 1; ci >= 0; --ci) {
    const long long base = (long long)start + (long long)ci * CI;
    const int nvalid = min(CI, count - ci * CI);
    __syncthreads();  // the previous chunk is done with shared memory
    if (tid < CI) {
      Geom q;
      derive(feats + base + tid, n_cap, (double)cxf, (double)cyf, q);
      s_g0[tid] = make_float4((float)q.A[0], (float)q.B[0], (float)q.cp[0], (float)q.A[1]);
      s_g1[tid] = make_float4((float)q.B[1], (float)q.cp[1], (float)q.A[2], (float)q.B[2]);
      s_g2[tid] = make_float4((float)q.cp[2], (float)q.da, (float)q.db, (float)q.dcc);
      s_g3[tid] = make_float4((float)q.sx, (float)q.sy, (float)q.s0, (float)q.lo);
      s_tw2[tid] = (float)q.Tw[2];
      const float* f = feats + base + tid;
      float c[8];
      if (PACKED) {
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

    // chunk-local suffix sums (over later instances of this chunk)
    float S_lf = 0.f, Bsum = 0.f, Wrun = 0.f, MWrun = 0.f, M2Wrun = 0.f;
    for (int sub = CI / SUB - 1; sub >= 0; --sub) {
      for (int il = SUB - 1; il >= 0; --il) {
        const int i = sub * SUB + il;
        float v[32];
#pragma unroll
        for (int k = 0; k < 32; ++k) v[k] = 0.f;
        const float rank = (float)(ci * CI + i + 1);
        bool contrib = false;
        // ranks past the pixel's n_contrib cannot contribute: no alpha test
        if (i < nvalid && rank <= ncon) {
          const float4 g0 = s_g0[i], g1 = s_g1[i], g2 = s_g2[i], g3 = s_g3[i];
          // the forward's pair arithmetic, verbatim (csrc/tile_blend_fwd.cu)
          const float p0 = g0.x * px + g0.y * py + g0.z;
          const float p1 = g0.w * px + g1.x * py + g1.y;
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
          const float s = fmaxf(s3, s2);
          const float alpha = expf(fminf(LOG_AMAX, s));
          const float depth = unstable ? s_tw2[i] : dn * ivp;
          contrib = depth >= NEAR_N && alpha >= ALPHA_MIN;
          if (contrib) {
            S_lf += -log1pf(-alpha);
            const float T_i = T_rev * expf(S_lf);
            const float w = alpha * T_i;
            const float4 c0 = s_c0[i], c1 = s_c1[i];
            const float cv[7] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z};
            float what = 0.f;
#pragma unroll
            for (int k = 0; k < 7; ++k) what += cv[k] * ct7[k];
            what += ct_d * depth;
            float d_depth = w * ct_d;
            float bterm;
            if (FULL) {
              const float safe_depth = fmaxf(depth, NEAR_N);
              const float m = M_C1 - M_C2 * (1.f / safe_depth);
              const float mw = m * w;
              const float m2w = m * mw;
              const float W_gt = Wsuf + Wrun;
              const float MW_gt = MWsuf + MWrun;
              const float M2W_gt = M2Wsuf + M2Wrun;
              const float M1_i = M1tot - MW_gt - mw;
              const float M2_i = M2tot - M2W_gt - m2w;
              const float A_i = 1.f - T_i;
              const float phi = m * m * A_i + M2_i - 2.f * m * M1_i +
                                m * m * W_gt - 2.f * m * MW_gt;
              what += ct_m1 * m + ct_m2 * m * m + ct_dist * phi;
              const float d_m_tot =
                  ct_m1 * w + 2.f * m * ct_m2 * w +
                  ct_dist * 2.f * w * (m * A_i - M1_i + m * W_gt - MW_gt);
              const float dm_dd = M_C2 / (safe_depth * safe_depth);  // depth >= NEAR_N
              d_depth += d_m_tot * dm_dd + (rank == med_rank ? ct_med : 0.f);
              bterm = what * w - ct_dist * w * m * m * T_i;
              Wrun += w;
              MWrun += mw;
              M2Wrun += m2w;
            } else {
              bterm = what * w;
            }
            const float B_i = Bc + Bsum;
            Bsum += bterm;
            const float d_alpha = T_i * what - B_i / (1.f - alpha);
            const float d_s = s < LOG_AMAX ? alpha * d_alpha : 0.f;
            const bool use3 = s3 >= s2 && !unstable;
            const float d_s3 = use3 ? d_s : 0.f;
            const float d_s2 = use3 ? 0.f : d_s;
            const bool lp = !unstable && !use3;  // stable, low-pass branch
            const float d_p0m = -d_s3 * p0 * ivp2;
            const float d_p1m = -d_s3 * p1 * ivp2;
            const float d_p2m =
                d_s3 * 2.f * r3h * ivp - (use3 ? dn * ivp2 * d_depth : 0.f);
            const float d_dnm = use3 ? d_depth * ivp : 0.f;
            const float d_lp = lp ? d_depth : 0.f;
            v[S_P0 + 0] = d_p0m * px; v[S_P0 + 1] = d_p0m * py; v[S_P0 + 2] = d_p0m;
            v[S_P1 + 0] = d_p1m * px; v[S_P1 + 1] = d_p1m * py; v[S_P1 + 2] = d_p1m;
            v[S_P2 + 0] = d_p2m * px; v[S_P2 + 1] = d_p2m * py; v[S_P2 + 2] = d_p2m;
            v[S_DN + 0] = d_dnm * px; v[S_DN + 1] = d_dnm * py; v[S_DN + 2] = d_dnm;
            v[S_S2 + 0] = d_s2 * px; v[S_S2 + 1] = d_s2 * py; v[S_S2 + 2] = d_s2;
            v[S_S3] = d_s3;
            v[S_TW2] = (unstable ? d_depth : 0.f) + d_lp;
            v[S_LPX] = d_lp * p0 * ivp;
            v[S_LPY] = d_lp * p1 * ivp;
#pragma unroll
            for (int k = 0; k < 7; ++k) v[S_CON + k] = ct7[k] * w;
          }
        }
        const bool any = __any_sync(ALL_LANES, contrib);
        if (any) {
          const float sum = transpose_sum(v, lane);
          if (lane < NSUM) s_part[warp][lane][il] = sum;
        }
        if (lane == 0) s_has[warp][il] = any;
      }
      __syncthreads();
      // the warp partials, summed in warp order (a warp without a
      // contributor adds nothing)
      for (int e = tid; e < NSUM * SUB; e += NPIX) {
        const int k = e / SUB, il = e % SUB;
        float acc = 0.f;
#pragma unroll
        for (int w8 = 0; w8 < NWARP; ++w8)
          if (s_has[w8][il]) acc += s_part[w8][k][il];
        s_part[0][k][il] = acc;
      }
      __syncthreads();
      // coefficient-space chain back to the raw rows, one thread per instance
      if (tid < SUB && sub * SUB + tid < nvalid) {
        const int i = sub * SUB + tid;
        float sm[NSUM];
#pragma unroll
        for (int k = 0; k < NSUM; ++k) sm[k] = s_part[0][k][tid];
        Geom qd;
        derive(feats + base + i, n_cap, (double)cxf, (double)cyf, qd);
        float Tu[3], Tv[3], Tw[3], A[3], B[3], C[3];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          Tu[k] = (float)qd.Tu[k]; Tv[k] = (float)qd.Tv[k]; Tw[k] = (float)qd.Tw[k];
          A[k] = (float)qd.A[k]; B[k] = (float)qd.B[k]; C[k] = (float)qd.C[k];
        }
        const float sx = (float)qd.sx, sy = (float)qd.sy;
        const float d_s0 = sm[S_S2 + 2];
        const float d_sx = sm[S_S2 + 0] - sx * (1.f / FI) * d_s0;
        const float d_sy = sm[S_S2 + 1] - sy * (1.f / FI) * d_s0;
        const float d_lo = sm[S_S3] + d_s0;
        // p_k = A_k x + B_k y + cp_k, cp = C + cx A + cy B
        float dA[3], dB[3], dC[3];
        float d_da = sm[S_DN + 0] + cxf * sm[S_DN + 2];
        float d_db = sm[S_DN + 1] + cyf * sm[S_DN + 2];
        const float d_dc = sm[S_DN + 2];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const float d_cp = sm[3 * k + 2];
          dA[k] = sm[3 * k + 0] + cxf * d_cp + d_da * Tw[k];
          dB[k] = sm[3 * k + 1] + cyf * d_cp + d_db * Tw[k];
          dC[k] = d_cp + d_dc * Tw[k];
        }
        float dTw[3] = {
            d_da * A[0] + d_db * B[0] + d_dc * C[0] + sm[S_LPX],
            d_da * A[1] + d_db * B[1] + d_dc * C[1] + sm[S_LPY],
            d_da * A[2] + d_db * B[2] + d_dc * C[2] + sm[S_TW2]};
        // cross-product VJPs: A = Tv x Tw, B = Tw x Tu, C = Tu x Tv
        auto cross = [](const float* a, const float* b, int k) {
          const int k1 = (k + 1) % 3, k2 = (k + 2) % 3;
          return a[k1] * b[k2] - a[k2] * b[k1];
        };
        float* o = d_feats + base + i;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          o[(long long)(0 + k) * n_cap] = cross(dB, Tw, k) + cross(Tv, dC, k);
          o[(long long)(3 + k) * n_cap] = cross(Tw, dA, k) + cross(dC, Tu, k);
          o[(long long)(6 + k) * n_cap] = cross(dA, Tv, k) + cross(Tu, dB, k) + dTw[k];
        }
        o[9LL * n_cap] = d_sx;
        o[10LL * n_cap] = d_sy;
        o[11LL * n_cap] = d_lo;
        const float* dcon = sm + S_CON;
        if (PACKED) {
          o[12LL * n_cap] = pack2(dcon[0], dcon[4]);
          o[13LL * n_cap] = pack2(dcon[1], dcon[5]);
          o[14LL * n_cap] = pack2(dcon[2], dcon[6]);
          o[15LL * n_cap] = pack2(dcon[3], 0.f);
        } else {
#pragma unroll
          for (int k = 0; k < 7; ++k) o[(long long)(12 + k) * n_cap] = dcon[k];
        }
      }
      __syncthreads();  // s_part is rewritten by the next round
    }
    // carries for the next (earlier) chunk
    T_rev = T_rev * expf(S_lf);
    Bc = Bc + Bsum;
    if (FULL) {
      Wsuf += Wrun;
      MWsuf += MWrun;
      M2Wsuf += M2Wrun;
    }
  }
}

template <bool FULL, bool PACKED>
cudaError_t launch(const float* feats, long long n_cap, const int* starts,
                   const int* counts, const int* used, const int* org_x,
                   const int* org_y, const float* fwd_px, const float* ct_px,
                   int n_tiles, float* d_feats, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      tile_blend_bwd_kernel<FULL, PACKED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, PART_BYTES);
  if (err != cudaSuccess) return err;
  tile_blend_bwd_kernel<FULL, PACKED><<<n_tiles, NPIX, PART_BYTES, stream>>>(
      feats, n_cap, starts, counts, used, org_x, org_y, fwd_px, ct_px, d_feats);
  return cudaGetLastError();
}

}  // namespace

// feats [16 | 24, n_cap] f32; starts/counts/used/org_x/org_y [n_tiles] i32;
// fwd_px/ct_px [n_tiles, 16, 256] f32; d_feats [16 | 24, n_cap] f32, zeroed
// by the caller (slots of unused chunks and pads stay 0). Launches on
// `stream` and returns cudaGetLastError().
extern "C" int tile_blend_bwd(const float* feats, long long n_cap,
                              const int* starts, const int* counts,
                              const int* used, const int* org_x,
                              const int* org_y, const float* fwd_px,
                              const float* ct_px, int n_tiles, float* d_feats,
                              int full_grads, int packed_feats, void* stream) {
  if (n_tiles <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (full_grads)
    return (int)(packed_feats
                     ? launch<true, true>(feats, n_cap, starts, counts, used, org_x,
                                          org_y, fwd_px, ct_px, n_tiles, d_feats, s)
                     : launch<true, false>(feats, n_cap, starts, counts, used, org_x,
                                           org_y, fwd_px, ct_px, n_tiles, d_feats, s));
  return (int)(packed_feats
                   ? launch<false, true>(feats, n_cap, starts, counts, used, org_x,
                                         org_y, fwd_px, ct_px, n_tiles, d_feats, s)
                   : launch<false, false>(feats, n_cap, starts, counts, used, org_x,
                                          org_y, fwd_px, ct_px, n_tiles, d_feats, s));
}

extern "C" const char* tile_blend_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
