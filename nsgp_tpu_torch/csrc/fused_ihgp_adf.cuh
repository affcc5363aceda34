// IHGP's steady ADF sweep for Hopper (sm_90a): every sequential forward pass
// of the infinite-horizon engine in one launch.
//
//   fused_ihgp_adf_kernel  replaces nsgp_tpu/inference/ihgp.py:402, the
//                          jax.lax.scan of _steady_filter_seq     (K5)
//
// Per step k, what ops/fused_ihgp.py:fused_ihgp_adf_plain computes:
//   fmu = (h'A) m;  varp, Ph_prev from the previous step's table row (step 0:
//   the Pinf row `first`);
//   where obs[k] and match[k]: the cubature moment match at (fmu, varp) with
//   frac 1 and the raw-scale Z floor, tt = max((1-damp) tt_in + damp (-d2 /
//   (1 + d2 varp)), 0) and tn likewise (the clamp propagates NaN); elsewhere
//   lZ = 0 and the incoming sites;
//   tt_eff = obs ? tt : 0; the emitted idx = lookup(tt_eff); the next row =
//   lookup(tt) (JAX carries tt, not tt_eff: the two differ on unobserved steps
//   with non-zero fixed sites);
//   gain = tt_eff > 0 ? (tn - tt_eff fmu) / (tt_eff varp + 1) : 0;
//   m = A m + Ph_prev gain.
// No covariance is propagated: the steady tables stand in for it.
//
// The moment match is adf_sweep's (adf_step.cuh), unchanged: one CTA at
// S = 77, a thread-block cluster of up to eight CTAs at mixture width
// (S = 3973).  What this file adds is the recursion policy SteadyRecursion:
// one thread a channel holds A, h'A, the mean and the current table row in
// registers.  The row a step needs depends on the step before it, so its
// load is on the critical path: the table (C, G, bs + 1) is staged in shared
// memory when it fits beside the sweep's layout under 227 KB (the headline
// model's 76 KB in float32, 152 KB in float64), else rows are read through
// L2.  The grid lookup rounds exactly as the plain version (no contraction
// into FMAs: __*_rn intrinsics), since one ulp can flip an index.
//
// Bound: as K3, the latency of a T-long recursion (adf_step.cuh); a step
// drops K3's covariance predict and update and keeps the moment match.
//
// Layouts, exactly T steps, one signal:
//   y, match, obs, lZ (T,)   tt_in, tn_in, tt, tn, idx (T, C)   ms (T, C, bs)
//   A (C, bs, bs)   H (C, bs)   first (C, bs + 1)   tab (C, G, bs + 1)
//   lk (4,): lo, hi, span, shift of the grid   W (D, N)   xi (S, N)   wn (S,)
//
// Build flags as fused_kalman.cuh (never --use_fast_math).  Compiled once per
// dtype, by fused_ihgp_adf_f32.cu and fused_ihgp_adf_f64.cu.

#pragma once

#include "adf_step.cuh"

namespace {

template <typename T>
struct SteadyArgs {
  const T* A;
  const T* H;
  const T* first;
  const T* tab;
  const T* lk;
  const T* obs;
  const T* tt_in;
  const T* tn_in;
  T* ms;
  T* lZ;
  T* tt;
  T* tn;
  int* idx;
  T omd;          // 1 - damp, rounded once from float64 as the plain version's scalar
  int G, staged;  // grid points; the table in shared memory (1) or read through L2
};

// Rounded exactly as written: the compiler may not fuse these into FMAs.
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float log10_(float x) { return log10f(x); }
__device__ __forceinline__ double log10_(double x) { return log10(x); }
__device__ __forceinline__ float floor_(float x) { return floorf(x); }
__device__ __forceinline__ double floor_(double x) { return floor(x); }

// Grid index of the effective noise R = 1 / tt, in the order of operations
// of ops/fused_ihgp.py:lookup_idx: -log10(max(tt, 1e-300)) (tt <= 0 or NaN:
// the top of the grid), then (logR - lo) / span * (G - 1), then
// floor(x - shift) + 1, clamped.  The 1e-300 floor is 0 in float32.
template <typename T>
__device__ __forceinline__ int steady_lookup(T tt, T lo, T hi, T span, T shift, int G) {
  const T logR = tt > T(0) ? -log10_(clamp_min(tt, T(1e-300))) : hi;
  const T x = mul_rn(div_rn(sub_rn(logR, lo), span), T(G - 1));
  const int i = (int)floor_(sub_rn(x, shift)) + 1;
  return i < 0 ? 0 : (i > G - 1 ? G - 1 : i);
}

template <typename T, int BS>
struct SteadyRecursion {
  using Args = SteadyArgs<T>;
  static constexpr int RW = BS + 1;  // a table row: Ph (bs), h'Ph
  Args a;
  T A[BS][BS], HA[BS], m[BS], row[RW];
  const T* tab_c;  // this channel's G rows
  T lo, hi, span, shift, damp;
  T tin, nin, seen;  // this step's incoming sites and observed flag
  int c, C;

  __device__ __forceinline__ SteadyRecursion(const Args& args, const AdfCore<T>& core, int,
                                             int c_, bool chan, T* extra)
      : a(args), damp(core.damp), c(c_), C(core.D + core.N) {
    const size_t tab_len = (size_t)C * a.G * RW;
    if (a.staged)  // read after the sweep's barrier before its first step
      for (size_t i = threadIdx.x; i < tab_len; i += ADF_THREADS) extra[i] = a.tab[i];
    if (chan) {
      tab_c = (a.staged ? extra : a.tab) + (size_t)c * a.G * RW;
      load_mat<T, BS>(A, a.A + (size_t)c * BS * BS);
      T H[BS];
#pragma unroll
      for (int i = 0; i < BS; ++i) H[i] = a.H[(size_t)c * BS + i];
#pragma unroll
      for (int j = 0; j < BS; ++j) {
        T s = T(0);
#pragma unroll
        for (int i = 0; i < BS; ++i) s += H[i] * A[i][j];
        HA[j] = s;
        m[j] = T(0);
      }
#pragma unroll
      for (int i = 0; i < RW; ++i) row[i] = a.first[(size_t)c * RW + i];
      lo = a.lk[0];
      hi = a.lk[1];
      span = a.lk[2];
      shift = a.lk[3];
    }
  }

  __device__ __forceinline__ void marginal(int t, T& fmu, T& var) {
    // loaded here, a moment match ahead of their use
    tin = a.tt_in[(size_t)t * C + c];
    nin = a.tn_in[(size_t)t * C + c];
    seen = a.obs[t];
    fmu = T(0);
#pragma unroll
    for (int j = 0; j < BS; ++j) fmu += HA[j] * m[j];
    var = row[BS];
  }

  __device__ __forceinline__ void advance(int t, bool matched, T lZk, T dl, T d2, T fmu, T var,
                                          bool store) {
    T tt = tin, tn = nin;  // not matched: the incoming sites, lZ = 0
    if (matched) {
      const T denom = T(1) + d2 * var;
      tt = clamp_min(a.omd * tin + damp * (-d2 / denom), T(0));
      tn = a.omd * nin + damp * ((dl - fmu * d2) / denom);
    }
    const bool observed = seen > T(0);
    const T te = observed ? tt : T(0);
    const int id = steady_lookup(te, lo, hi, span, shift, a.G);
    const int id_next = observed ? id : steady_lookup(tt, lo, hi, span, shift, a.G);
    // the reference's gain: K = PP(R_{k-1}) h / (h'PP(R_{k-1}) h + R_k), in
    // z-form, with the hard pure-prediction branch at tt_eff == 0
    const T gain = te > T(0) ? (tn - te * fmu) / (te * var + T(1)) : T(0);
    T mn[BS];
#pragma unroll
    for (int i = 0; i < BS; ++i) {
      T s = T(0);
#pragma unroll
      for (int j = 0; j < BS; ++j) s += A[i][j] * m[j];
      mn[i] = s + row[i] * gain;
    }
#pragma unroll
    for (int i = 0; i < BS; ++i) m[i] = mn[i];
    const T* r = tab_c + (size_t)id_next * RW;
#pragma unroll
    for (int i = 0; i < RW; ++i) row[i] = r[i];
    if (store) {
      const size_t o = (size_t)t * C + c;
      a.tt[o] = tt;
      a.tn[o] = tn;
      a.idx[o] = id;
      if (c == 0) a.lZ[t] = lZk;
#pragma unroll
      for (int i = 0; i < BS; ++i) a.ms[o * BS + i] = m[i];
    }
  }
};

template <typename T, int BS>
__global__ void __launch_bounds__(ADF_THREADS, 1)
fused_ihgp_adf_kernel(AdfCore<T> core, SteadyArgs<T> steady) {
  adf_sweep<T, BS, SteadyRecursion<T, BS>>(core, steady);
}

template <typename T, int BS>
int launch_ihgp_adf(const void* y, const void* match, const void* obs, const void* tt_in,
                    const void* tn_in, const void* A, const void* H, const void* first,
                    const void* tab, const void* lk, const void* W, const void* xi,
                    const void* wn, const void* sn2, double damp, double omd, double log_floor,
                    double sq_floor, int n_steps, int D, int N, int S, int G, int link_exp,
                    int sq, void* ms, void* idx, void* lZ, void* tt, void* tn, cudaStream_t st) {
  if (G < 1) return -2;
  SteadyArgs<T> steady{(const T*)A,  (const T*)H,     (const T*)first, (const T*)tab,
                       (const T*)lk, (const T*)obs,   (const T*)tt_in, (const T*)tn_in,
                       (T*)ms,       (T*)lZ,          (T*)tt,          (T*)tn,
                       (int*)idx,    (T)omd,          G,               0};
  const size_t tab_bytes = (size_t)(D + N) * G * (BS + 1) * sizeof(T);
  steady.staged = adf_smem_bytes<T>(D, N, S) + tab_bytes <= ADF_SMEM_MAX;
  // the moment match's steps: obs & match, as the sweep's observed flags
  return launch_adf_sweep<T>(
      fused_ihgp_adf_kernel<T, BS>,
      adf_core<T>(y, match, W, xi, wn, sn2, damp, log_floor, sq_floor, n_steps, /*BF=*/1, D, N,
                  S, link_exp, sq, nullptr),
      steady, steady.staged ? tab_bytes : 0, st);
}

}  // namespace

// The C entry point of one dtype: nsgp_fused_ihgp_adf_<SUFFIX>.  `match` is
// obs & match as 0/1 (the steps that run the moment match), `obs` the
// observed flags; idx is int32.
#define NSGP_DEFINE_FUSED_IHGP_ADF(SUFFIX, T)                                                 \
  extern "C" int nsgp_fused_ihgp_adf_##SUFFIX(                                                \
      int bs, const void* y, const void* match, const void* obs, const void* tt_in,           \
      const void* tn_in, const void* A, const void* H, const void* first, const void* tab,    \
      const void* lk, const void* W, const void* xi, const void* wn, const void* sn2,         \
      double damp, double omd, double log_floor, double sq_floor, int n_steps, int D, int N,  \
      int S, int G, int link_exp, int sq, void* ms, void* idx, void* lZ, void* tt, void* tn,  \
      void* stream) {                                                                         \
    cudaStream_t st = (cudaStream_t)stream;                                                   \
    NSGP_DISPATCH_BS(launch_ihgp_adf, T, y, match, obs, tt_in, tn_in, A, H, first, tab, lk,   \
                     W, xi, wn, sn2, damp, omd, log_floor, sq_floor, n_steps, D, N, S, G,     \
                     link_exp, sq, ms, idx, lZ, tt, tn, st)                                   \
  }
