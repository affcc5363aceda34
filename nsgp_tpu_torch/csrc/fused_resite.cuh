// The all-T EP re-site for Hopper (sm_90a): every site's cavity, moment
// match and damped update in one launch.
//
//   fused_resite_kernel  replaces no Pallas kernel: the JAX package leaves
//                        the re-site to XLA (nsgp_tpu/inference/ep.py,
//                        moments_chunked); in the port it was plain torch,
//                        inference/ep.py:_ep_resite (K9)
//
// What it computes (ops/fused_kalman.py:fused_resite_plain, which is the
// plain path of _ep_resite), for each step t with mask[t], per channel c:
//
//   v_raw = 1 / (1 / var - frac tt),   ok = v_raw > 0
//   v_cav = ok ? v_raw : 1,            m_cav = ok ? v_raw (mu / var - frac tn) : 0
//   lZ, dlZ, d2lZ of the cavity's moment match over the S sigma points
//   (ops/moments.py:moments with s2e = a^2 s2_z + sn2 / frac, the raw-scale Z
//   floor and, with use_pep_const, the same constant added to lZ)
//   tt' = clamp_min(ok ? keep tt + damp (-d2 / den) : tt, 0)
//   tn' = ok ? keep tn + damp ((dl - m_cav d2) / den) : tn
//   with den = 1 + d2 v_cav and keep = 1 - damp frac.
// A step with mask[t] false is not matched: tt' = clamp_min(tt, 0), tn' = tn,
// lZ = 0.
//
// What bounds it.  Sites are independent: T sites of S sigma points, about
// 1600 operations a point at D = 48, N = 9 (benchmark/counts.py:sigma_flops),
// against 4C + 2 values read and 2C + 1 written a site.  So it is bound by
// operations (103 GFLOP a re-site at T = 16 000, S = 3973: 1.5 ms at
// 67 TFLOP/s), where the plain path wrote every (chunk, S, D) intermediate to
// device memory and read it back some fifteen times.
//
// What the design does about it.
//
// * One warp a site, nothing of size (T, S, D) written: a site's points are
//   matched in registers and its K = 1 + 2D + 2N totals never leave the warp.
// * adf_step.cuh's per-point machinery, AdfWarp, the code K3-K8 run on
//   each warp's share of a step's points: G lanes a point, PB points a lane
//   (a function of S: 4 where a site has more than 512 points, else 2),
//   a[PB][DB] amplitudes in registers, W transposed in shared memory and read
//   as one 16-byte load a modulator, the warp's link values in its own stash,
//   each lane's 17 totals under its own running shift; merge_warp, then
//   merge_partials over the warp's one record, so no block barrier is crossed
//   after W is staged.  adf_derivatives gives lZ and the two derivatives with
//   the raw-scale Z floor and the "shift not finite -> 0" rule.
// * The unit sigma points (159 KB at S = 3973, N = 9) are read from global
//   memory, where L1 and L2 hold them, not staged: staging them would leave
//   one CTA an SM.
// * A few sites a CTA (8 warps; fewer only where W and the warps' segments
//   would not fit the block's shared memory), one site a warp, the grid over
//   T.  A masked site writes its old sites and lZ = 0 and skips the match.
// * 'sq' amplitudes are sqrt_pos(max(a, sq_floor)) with sq_floor the dtype's
//   smallest normal: rsqrt of 0 would give NaN where the plain path's sqrt
//   gives 0.
//
// Kept: no --use_fast_math, a clamp_min that propagates NaN, no atomics (two
// runs give the same bits).
//
// Layouts, exactly T sites: y, lZ (T,); mask (T,) bool (one byte); mu, var,
// tt, tn, tt_out, tn_out (T, C); W (D, N); xi (S, N); wn (S,); sn2 (1,);
// pep (1,) or null.
//
// Build flags as fused_kalman.cuh (never --use_fast_math).  Compiled once per
// dtype, by fused_resite_f32.cu and fused_resite_f64.cu.

#pragma once

#include "adf_step.cuh"

namespace {

constexpr int RESITE_WARPS = 8;  // sites a CTA, at most
constexpr int RESITE_THREADS = 32 * RESITE_WARPS;

// Sigma points a lane takes per round: a function of S alone.
__host__ __device__ inline int resite_points_per_lane(int S) {
  return S > ADF_POINTS_PER_CTA ? ADF_PB_CLUSTER : ADF_PB_ONE;
}

// A site's warp takes adf_lane_map's lanes; the shared layout (offsets in
// elements of T, every segment a multiple of four so the Packs stay aligned)
// is W transposed once a CTA, then each warp's own segment.
struct ResiteLayout {
  AdfLayout lanes;
  int mslot;     // the shift's index in a warp's record
  int warp0;     // the first warp's segment, after W transposed ([N][Dp] from 0)
  int per_warp;  // a warp's segment
  int fmu, hph, mug, sdg, lk, rec;  // within a warp's segment
  int total;
};

__host__ __device__ inline ResiteLayout resite_layout(int D, int N, int PB, int warps) {
  ResiteLayout L;
  adf_lane_map(L.lanes, D, N, PB);
  const int Dp = L.lanes.Dp;
  L.mslot = L.lanes.G * ADF_NACC;
  int o = 0;
  L.fmu = o; o += Dp;
  L.hph = o; o += Dp;
  L.mug = o; o += Dp;
  L.sdg = o; o += Dp;
  L.lk = o; o += adf_r4(N * L.lanes.PT);
  L.rec = o; o += L.lanes.rec;
  L.per_warp = o;
  L.warp0 = adf_r4(N * Dp);
  L.total = L.warp0 + warps * L.per_warp;
  return L;
}

// Sites a CTA: RESITE_WARPS, halved while the layout exceeds the block's
// shared memory (only at the widest models in float64).
__host__ __device__ inline int resite_warps(int D, int N, int S, size_t elem) {
  const int PB = resite_points_per_lane(S);
  int w = RESITE_WARPS;
  while (w > 1 && (size_t)resite_layout(D, N, PB, w).total * elem > ADF_SMEM_MAX) w >>= 1;
  return w;
}

template <typename T>
struct ResiteArgs {
  const T* y;
  const unsigned char* mask;
  const T* mu;
  const T* var;
  const T* tt;
  const T* tn;
  const T* W;
  const T* xi;
  const T* wn;
  const T* sn2;
  const T* pep;  // null without use_pep_const
  T* tt_out;
  T* tn_out;
  T* lZ;
  T frac, damp, keep, log_floor, sq_floor;
  int n_sites, D, N, S, link_exp, sq;
};

// Channel c's cavity at row i of a matched site; returns ok.
template <typename T>
__device__ __forceinline__ bool resite_cavity(const ResiteArgs<T>& a, size_t i, T& vc, T& mc) {
  const T v = a.var[i];
  const T vraw = T(1) / (T(1) / v - a.frac * a.tt[i]);
  const bool ok = vraw > T(0);
  vc = ok ? vraw : T(1);
  mc = ok ? vraw * (a.mu[i] / v - a.frac * a.tn[i]) : T(0);
  return ok;
}

template <typename T, int PB>
__global__ void __launch_bounds__(RESITE_THREADS, 2)
fused_resite_kernel(const ResiteArgs<T> a, const int warps) {
  constexpr int DB = ADF_DB, NACC = ADF_NACC;
  const int D = a.D, N = a.N, C = D + N;
  const ResiteLayout L = resite_layout(D, N, PB, warps);
  const int Dp = L.lanes.Dp;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sh = reinterpret_cast<T*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31;

  // ---- once a CTA: W transposed, zero beyond D; each warp's padding -------
  for (int i = tid; i < N * Dp; i += blockDim.x) {
    const int n = i / Dp, d = i - n * Dp;
    sh[i] = d < D ? a.W[d * N + n] : T(0);
  }
  T* own = sh + L.warp0 + (tid >> 5) * L.per_warp;
  for (int i = lane; i < 4 * Dp; i += 32) own[L.fmu + i] = T(0);
  AdfWarp<T, PB> pw;  // the site's points, matched by this warp
  pw.L = L.lanes;
  pw.sn2 = a.frac == T(1) ? a.sn2[0] : a.sn2[0] / a.frac;
  pw.sq_floor = a.sq_floor;
  pw.N = N;
  pw.S = a.S;
  pw.lane = lane;
  pw.g_lane = lane & (L.lanes.G - 1);
  pw.grp = lane >> L.lanes.lg;
  pw.d0 = pw.g_lane * DB;
  pw.link_exp = a.link_exp != 0;
  pw.sq = a.sq != 0;
  pw.fmu_z = own + L.fmu;
  pw.hph_z = own + L.hph;
  pw.mu_g = own + L.mug;
  pw.sd_g = own + L.sdg;  // sqrt(max(v_cav, 0))
  pw.Wt = sh;
  pw.lk_w = own + L.lk;
  T* rec = own + L.rec;  // the warp's merged record: G * NACC totals, the shift
  __syncthreads();

  const int t = blockIdx.x * warps + (tid >> 5);  // this warp's site
  if (t >= a.n_sites) return;
  const size_t row = (size_t)t * C;
  if (a.mask[t] == 0) {  // not matched: the old sites, clamped, and lZ = 0
    for (int c = lane; c < C; c += 32) {
      a.tt_out[row + c] = clamp_min(a.tt[row + c], T(0));
      a.tn_out[row + c] = a.tn[row + c];
    }
    if (lane == 0) a.lZ[t] = T(0);
    return;
  }

  // ---- the cavity, where the points read it --------------------------------
  for (int c = lane; c < C; c += 32) {
    T vc, mc;
    resite_cavity(a, row + c, vc, mc);
    if (c < D) {
      pw.fmu_z[c] = mc;
      pw.hph_z[c] = vc;
    } else {
      pw.mu_g[c - D] = mc;
      pw.sd_g[c - D] = Num<T>::sqrt_(clamp_min(vc, T(0)));
    }
  }
  __syncwarp();

  // ---- the points, round by round, into each lane's totals; the warp's merge
  T acc[NACC], m_run = T(-INFINITY);
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = T(0);
  AdfProbe probe(false);
  const T yk = a.y[t];
  for (int s0 = 0; s0 < a.S; s0 += L.lanes.PT)
    pw.add_round(yk, s0, a.xi + (size_t)s0 * N, a.wn + s0, acc, m_run, probe);
  pw.merge_warp(acc, m_run);
  if (pw.grp == 0) {  // group 0 holds the warp's record
#pragma unroll
    for (int i = 0; i < NACC; ++i) rec[pw.g_lane * NACC + i] = acc[i];
    if (pw.g_lane == 0) rec[L.mslot] = m_run;
  }
  __syncwarp();

  // ---- per channel: derivatives, then the damped site update -------------
  const T* rec_c = rec;
  for (int c = lane; c < C; c += 32) {
    T vc, mc;
    const bool ok = resite_cavity(a, row + c, vc, mc);
    const int o = c < D ? c : c - D;
    const int k1 = (o / DB) * NACC + 1 + (c < D ? 0 : 2 * DB) + o % DB;
    const int slots[3] = {0, k1, k1 + DB};
    T tot[3];
    const T m_all = merge_partials<T, 3>(1, [&](int) { return rec_c; }, L.mslot, slots, tot);
    T lZk, dl, d2;
    adf_derivatives<T>(tot, m_all, c >= D, vc, Num<T>::sqrt_(clamp_min(vc, T(0))), a.log_floor,
                       lZk, dl, d2);
    const T tt0 = a.tt[row + c], tn0 = a.tn[row + c];
    T tt1 = tt0, tn1 = tn0;
    if (ok) {
      const T den = T(1) + d2 * vc;
      tt1 = a.keep * tt0 + a.damp * (-d2 / den);
      tn1 = a.keep * tn0 + a.damp * ((dl - mc * d2) / den);
    }
    a.tt_out[row + c] = clamp_min(tt1, T(0));
    a.tn_out[row + c] = tn1;
    if (c == 0) a.lZ[t] = a.pep != nullptr ? lZk + a.pep[0] : lZk;
  }
}

// Launch K9 over T sites.  Returns 0, a CUDA error, or -2 for a width the
// mapping cannot take.
template <typename T, int PB>
int launch_resite_pb(const ResiteArgs<T>& a, cudaStream_t st) {
  const int warps = resite_warps(a.D, a.N, a.S, sizeof(T));
  const size_t bytes = (size_t)resite_layout(a.D, a.N, PB, warps).total * sizeof(T);
  if (bytes > ADF_SMEM_MAX) return -2;
  auto kern = fused_resite_kernel<T, PB>;
  if (bytes > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const unsigned grid = (unsigned)((a.n_sites + warps - 1) / warps);
  kern<<<grid, 32 * warps, bytes, st>>>(a, warps);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_resite(const void* y, const void* mask, const void* mu, const void* var,
                  const void* tt, const void* tn, const void* W, const void* xi, const void* wn,
                  const void* sn2, const void* pep, double frac, double damp, double log_floor,
                  double sq_floor, int n_sites, int D, int N, int S, int link_exp, int sq,
                  void* tt_out, void* tn_out, void* lZ, cudaStream_t st) {
  if (n_sites < 1 || D < 1 || N < 1 || S < 1 || D > ADF_MAX_WIDTH || N > ADF_MAX_WIDTH)
    return -2;
  // keep = 1 - damp frac in double, then rounded once, as the plain path's
  // Python scalar is
  const ResiteArgs<T> a{(const T*)y, (const unsigned char*)mask, (const T*)mu, (const T*)var,
                        (const T*)tt, (const T*)tn, (const T*)W, (const T*)xi, (const T*)wn,
                        (const T*)sn2, (const T*)pep, (T*)tt_out, (T*)tn_out, (T*)lZ, (T)frac,
                        (T)damp, (T)(1.0 - damp * frac), (T)log_floor, (T)sq_floor, n_sites, D,
                        N, S, link_exp, sq};
  return resite_points_per_lane(S) == ADF_PB_CLUSTER ? launch_resite_pb<T, ADF_PB_CLUSTER>(a, st)
                                                     : launch_resite_pb<T, ADF_PB_ONE>(a, st);
}

}  // namespace

// The C entry point of one dtype: nsgp_fused_resite_<SUFFIX>.
#define NSGP_DEFINE_FUSED_RESITE(SUFFIX, T)                                                    \
  extern "C" int nsgp_fused_resite_##SUFFIX(                                                   \
      const void* y, const void* mask, const void* mu, const void* var, const void* tt,        \
      const void* tn, const void* W, const void* xi, const void* wn, const void* sn2,          \
      const void* pep, double frac, double damp, double log_floor, double sq_floor,            \
      int n_sites, int D, int N, int S, int link_exp, int sq, void* tt_out, void* tn_out,      \
      void* lZ, void* stream) {                                                                \
    return launch_resite<T>(y, mask, mu, var, tt, tn, W, xi, wn, sn2, pep, frac, damp,         \
                            log_floor, sq_floor, n_sites, D, N, S, link_exp, sq, tt_out,       \
                            tn_out, lZ, (cudaStream_t)stream);                                 \
  }
