// The reverse of K5's steady ADF sweep for Hopper (sm_90a): the
// vector-Jacobian product of IHGP's sweep 1, the backward of
// fused_ihgp.FusedIHGPADF.
//
//   fused_ihgp_adf_vjp_kernel  counterpart of the transposed scan that
//                              jax.grad(ihgp_energy) derives from the lax.scan
//                              of nsgp_tpu/inference/ihgp.py:402  (K8)
//
// In: K5's inputs, its outputs ms (T, C, bs), idx and tt (T, C), and the
// cotangents of ms, lZ, tt and tn (a null pointer is a zero cotangent).  Out:
// the cotangents of A (C, bs, bs), H (C, bs), first (C, bs + 1), tab (C, G,
// bs + 1), W (D, N) and sn2.  y, the flags, the incoming sites, the grid, xi
// and wn get none; the lookup is piecewise constant, as JAX's integer index.
//
// What bounds it.  Like K5, a T-long recursion, walked from t = T-1 down to
// 0: the cotangent of step t's mean is needed before step t-1 can start.
// Bytes and operations are orders of magnitude below the card's rates; what
// counts is the latency of a reverse step on one SM, which is the moment
// match and its reverse (K5 carries no covariance, so neither does K8).
//
// What the design does about it (K7's design, fused_adf_vjp.cuh, carried
// over to the steady recursion):
//
// * Walk and recompute, no stash.  Step t is re-derived from the stored
//   ms[t-1] (0 at t = 0) and the row it read: first at t = 0, else
//   tab[c, id_next(t-1)].  The row index comes from the forward's outputs,
//   id_next = obs ? idx : lookup(tt) with K5's own steady_lookup, never from a
//   recomputed site: in float32 one ulp flips an index.  Then adf_step.cuh's
//   match (K3's thread map and code) re-derives the totals, the channel
//   threads run backwards through the mean update m = A m_prev + Ph gain, the
//   gain (its pure-prediction branch at tt_eff == 0 passes nothing), the
//   damped site clamped at 0, the derivatives of log Z, then match_vjp (one
//   pass over the points at the merged shift), then fmu = (h'A) m_prev.
// * One CTA of ADF_THREADS, K3's thread map; any S that K5 takes, the points
//   walked in rounds inside the CTA (no cluster).
// * Four block barriers a matched step (match's two, one after the channel
//   threads publish the cotangents of the totals, one in match_vjp); none on
//   a step that is not matched.
// * No atomics.  The table's cotangent is a scatter into the rows the steps
//   read: each channel thread owns its channel's (G, bs + 1) float64 sums.
//   The sums of A (its direct part), h'A, W (per lane) and sn2 (per thread)
//   are float64 too, each owned by one thread; one fixed-order reduction at
//   the end.  The sums sit in shared memory where they fit beside the
//   sweep's layout (the headline model: 152 KB of table sums), else in the
//   wrapper's scratch.  Two runs give the same bits.
// * The max shift is a constant (it carries no gradient); the clamps pass
//   the cotangent where they do not bind (x >= bound, as torch's clamp_min).
//
// fused_ihgp.fused_ihgp_adf_vjp_plain is the plain version, in this step
// order.  Build flags as fused_kalman.cuh (never --use_fast_math); compiled
// once per dtype, by fused_ihgp_adf_vjp_f32.cu and fused_ihgp_adf_vjp_f64.cu.

#pragma once

#include "fused_ihgp_adf.cuh"

namespace {

template <typename T>
struct IhgpVjpArgs {
  const T* A;
  const T* H;
  const T* first;
  const T* tab;
  const T* lk;
  const T* obs;  // observed flags (the matched steps are AdfCore's obs)
  const T* tt_in;
  const T* tn_in;
  const T* ms;  // K5's outputs
  const int* idx;
  const T* tt;
  const T* g_ms;  // the cotangents of K5's outputs, null = zero
  const T* g_lZ;
  const T* g_tt;
  const T* g_tn;
  T* gA;
  T* gH;
  T* gfirst;
  T* gtab;
  T* gW;
  T* gsn2;
  double* scratch;  // the float64 sums where shared memory cannot hold them
  T omd;            // 1 - damp, as K5's
  int G;
};

// K8's shared memory after the sweep's layout: offsets in elements of T,
// then the float64 part from byte `dbl`: the sn2 partials, then the sums
// that fit ([npar][C] of A and h'A, then W's [N][DB][threads]), then the
// table's [C][G][bs + 1].
struct IhgpVjpLayout {
  int g4, zi, zd, scal, lkbar;
  size_t dbl;
  int npar, nw, sums_shared, tab_shared;
  size_t bytes;
};

__host__ __device__ inline IhgpVjpLayout ihgp_vjp_layout(int D, int N, int S, int BS, int G,
                                                         size_t elem) {
  const AdfLayout L = adf_layout(D, N, S, 1, elem);
  IhgpVjpLayout V;
  int o = L.total;
  V.g4 = o; o += 4 * L.Dp;  // the totals' cotangents: A1, A2, X1, X2
  V.zi = o; o += adf_r4(D + N);  // each channel's share of Zi's and Z's
  V.zd = o; o += adf_r4(D + N);
  V.scal = o; o += 8;  // the step's scalars, from channel 0
  V.lkbar = o; o += adf_r4(ADF_NW * N * L.PT);  // the warps' link cotangents
  V.dbl = ((size_t)o * elem + 15) & ~(size_t)15;
  V.npar = BS * BS + BS;
  V.nw = N * ADF_DB * ADF_THREADS;
  const size_t sums = ((size_t)(D + N) * V.npar + V.nw) * sizeof(double);
  const size_t tabs = (size_t)(D + N) * G * (BS + 1) * sizeof(double);
  size_t bytes = V.dbl + ADF_THREADS * sizeof(double);
  V.sums_shared = bytes + sums <= ADF_SMEM_MAX;
  bytes += V.sums_shared ? sums : 0;
  V.tab_shared = bytes + tabs <= ADF_SMEM_MAX;
  V.bytes = bytes + (V.tab_shared ? tabs : 0);
  return V;
}

// float64 values the wrapper's scratch must hold: every sum, wherever it sits.
__host__ inline size_t ihgp_vjp_scratch_doubles(int D, int N, int BS, int G) {
  return (size_t)(D + N) * (BS * BS + BS + (size_t)G * (BS + 1)) +
         (size_t)N * ADF_DB * ADF_THREADS;
}

template <typename T, int BS>
__global__ void __launch_bounds__(ADF_THREADS, 1)
fused_ihgp_adf_vjp_kernel(AdfCore<T> core, IhgpVjpArgs<T> va) {
  constexpr int NT = ADF_THREADS, PB = ADF_PB_ONE, DB = ADF_DB, BB = BS * BS, RW = BS + 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sh = reinterpret_cast<T*>(smem_raw);
  const AdfStep<T, PB> st(core, 0, 1, sh);
  const int D = core.D, N = core.N, C = D + N, Dp = st.L.Dp, G = va.G;
  const IhgpVjpLayout V = ihgp_vjp_layout(D, N, core.S, BS, G, sizeof(T));
  const int tid = st.tid, c = tid, own = st.own;
  const bool chan = st.chan, mod = tid >= D;
  T* g4 = sh + V.g4;
  T* zi = sh + V.zi;
  T* zd = sh + V.zd;
  T* scal = sh + V.scal;
  T* lkbar_w = sh + V.lkbar + st.w * N * st.L.PT;
  double* sn2_part = reinterpret_cast<double*>(smem_raw + V.dbl);
  const size_t n_sums = (size_t)C * V.npar + V.nw, n_tab = (size_t)C * G * RW;
  double* psum = V.sums_shared ? sn2_part + NT : va.scratch;  // [npar][C]: A, h'A
  double* wacc = psum + (size_t)C * V.npar;                  // [N][DB][NT]
  double* gts = V.tab_shared ? sn2_part + NT + (V.sums_shared ? n_sums : 0)
                             : va.scratch + n_sums;  // [C][G][RW]
  for (size_t i = tid; i < n_sums; i += NT) psum[i] = 0.0;
  for (size_t i = tid; i < n_tab; i += NT) gts[i] = 0.0;
  for (int i = tid; i < 4 * Dp; i += NT) g4[i] = T(0);
  const T tiny = Num<T>::tiny(), log_floor = core.log_floor, damp = core.damp, omd = va.omd;
  T A[BS][BS], HA[BS], m_bar[BS];  // m_bar: the cotangent of step t's mean
  T lo = T(0), hi = T(0), span = T(1), shift = T(0);
  if (chan) {
    load_mat<T, BS>(A, va.A + (size_t)c * BB);
#pragma unroll
    for (int j = 0; j < BS; ++j) {
      T s = T(0);
#pragma unroll
      for (int i = 0; i < BS; ++i) s += va.H[(size_t)c * BS + i] * A[i][j];
      HA[j] = s;
      m_bar[j] = T(0);
    }
    lo = va.lk[0];
    hi = va.lk[1];
    span = va.lk[2];
    shift = va.lk[3];
  }
  double gsn2 = 0.0;
  AdfProbe probe(false);
  __syncthreads();

  for (int t = core.n_steps - 1; t >= 0; --t) {
    const T yk = core.y[t];
    const bool matched = core.obs[t] > T(0);  // uniform over the CTA

    // ---- 1. re-derive step t's marginal from ms[t-1] and the row it read ---
    T fmu = T(0), var = T(0), sd = T(0), m0[BS], Ph[BS];
    int id_prev = 0;
    if (chan) {
      const T* row = va.first + (size_t)c * RW;
      if (t > 0) {
        const size_t o = (size_t)(t - 1) * C + c;
        id_prev = va.obs[t - 1] > T(0) ? va.idx[o]
                                       : steady_lookup(va.tt[o], lo, hi, span, shift, G);
        row = va.tab + ((size_t)c * G + id_prev) * RW;
#pragma unroll
        for (int i = 0; i < BS; ++i) m0[i] = va.ms[o * BS + i];
      } else {
#pragma unroll
        for (int i = 0; i < BS; ++i) m0[i] = T(0);
      }
#pragma unroll
      for (int i = 0; i < BS; ++i) Ph[i] = row[i];
      var = row[BS];
#pragma unroll
      for (int j = 0; j < BS; ++j) fmu += HA[j] * m0[j];
      if (matched) st.publish(fmu, var, sd);
      if (va.g_ms) {
        const size_t o = ((size_t)t * C + c) * BS;
#pragma unroll
        for (int i = 0; i < BS; ++i) m_bar[i] += va.g_ms[o + i];
      }
    }

    // ---- 2, 3. re-derive the totals of the sigma points (K3's code) ---------
    T tot[3] = {T(0), T(0), T(0)}, m_all = T(0);
    if (matched) st.match(yk, 0, tot, m_all, probe);

    // ---- 4 backwards: the mean update, the gain, the site, log Z ----------
    T g_fmu = T(0), g_var = T(0), g_sd = T(0), g_Ph[BS];
    if (chan) {
      const size_t o = (size_t)t * C + c;
      const bool seen = va.obs[t] > T(0);
      // step t forwards from the totals, as adf_derivatives and K5's advance
      const T mall = Num<T>::finite(m_all) ? m_all : T(0);
      const T Z = tot[0], X1 = tot[1], X2 = tot[2];
      T S1 = X1, S2 = X2, is2 = T(0), rg = T(0), Z0 = T(1), lZ_raw = T(0), e = T(1);
      T Zi = T(0), dl = T(0), d2 = T(0), denom = T(1), r = T(0), q = T(0), pre = T(0);
      T tt = va.tt_in[o], tn = va.tn_in[o];  // not matched: the incoming sites
      if (matched) {
        if (mod) {
          is2 = T(1) / var;
          rg = sd * is2;
          S1 = X1 * rg;
          S2 = X2 * (rg * rg) - is2 * Z;
        }
        Z0 = clamp_min(Z, tiny);
        lZ_raw = mall + Num<T>::log_(Z0);
        const T lZk = clamp_min(lZ_raw, log_floor);
        e = Num<T>::exp_(lZ_raw - lZk);
        Zi = e / Z0;
        dl = Zi * S1;
        d2 = Zi * S2 - dl * dl;
        denom = T(1) + d2 * var;
        r = -d2 / denom;
        q = (dl - fmu * d2) / denom;
        pre = omd * tt + damp * r;
        tt = clamp_min(pre, T(0));
        tn = omd * tn + damp * q;
      }
      const T te = seen ? tt : T(0);
      const bool pos = te > T(0);
      const T z = te * var + T(1);
      const T gain = pos ? (tn - te * fmu) / z : T(0);
      // m = A m0 + Ph gain backwards: A's direct part, Ph's and the gain's
      T g_gain = T(0);
#pragma unroll
      for (int i = 0; i < BS; ++i) {
        g_gain += Ph[i] * m_bar[i];
        g_Ph[i] = gain * m_bar[i];
#pragma unroll
        for (int j = 0; j < BS; ++j)
          psum[(size_t)(i * BS + j) * C + c] += (double)(m_bar[i] * m0[j]);
      }
      if (!pos) g_gain = T(0);
      // gain = (tn - te fmu) / z, z = te var + 1
      const T g_num = g_gain / z, g_z = -g_gain * gain / z;
      const T g_tn = g_num + (va.g_tn ? va.g_tn[o] : T(0));
      T g_tt = va.g_tt ? va.g_tt[o] : T(0);
      if (seen) g_tt += -g_num * fmu + g_z * var;
      g_fmu = -g_num * te;
      g_var = g_z * te;
      if (matched) {
        // tt = max(omd tt_in + damp r, 0), r = -d2 / denom; tn = omd tn_in + damp q,
        // q = (dl - fmu d2) / denom
        const T g_r = pre >= T(0) ? damp * g_tt : T(0);
        const T g_q = damp * g_tn;
        const T g_den = -(g_q * q + g_r * r) / denom;
        T g_dl = g_q / denom;
        const T g_d2 = -g_q * fmu / denom - g_r / denom + g_den * var;
        g_fmu -= g_q * d2 / denom;
        g_var += g_den * d2;
        // dl = Zi S1, d2 = Zi S2 - dl^2
        g_dl -= T(2) * dl * g_d2;
        const T g_S1 = g_dl * Zi, g_S2 = g_d2 * Zi;
        zi[c] = g_d2 * S2 + g_dl * S1;
        if (mod) {  // S1 = rg X1, S2 = rg^2 X2 - Z / var, rg = sd / var
          const T g_rg = g_S1 * X1 + T(2) * rg * g_S2 * X2;
          const T g_is2 = g_rg * sd - g_S2 * Z;
          g_sd = g_rg * is2;
          g_var -= g_is2 * is2 * is2;
          zd[c] = -is2 * g_S2;
          g4[2 * Dp + own] = g_S1 * rg;
          g4[3 * Dp + own] = g_S2 * (rg * rg);
        } else {
          zd[c] = T(0);
          g4[own] = g_S1;
          g4[Dp + own] = g_S2;
        }
        if (c == 0) {
          scal[0] = Z0;
          scal[1] = e;
          scal[2] = Zi;
          scal[3] = lZ_raw >= log_floor ? T(1) : T(0);
          scal[4] = Z >= tiny ? T(1) : T(0);
          scal[5] = va.g_lZ ? va.g_lZ[t] : T(0);
          scal[6] = mall;
        }
      }
    }

    // ---- 2, 3 backwards: Z's cotangent, then the sigma points --------------
    if (matched) {
      __syncthreads();
      T g_Zi = T(0), g_Zd = T(0);
      for (int i = 0; i < C; ++i) {
        g_Zi += zi[i];
        g_Zd += zd[i];
      }
      // Zi = exp(lZ_raw - lZk) / Z0, lZk = max(lZ_raw, log_floor),
      // lZ_raw = shift + log Z0, Z0 = max(Z, tiny)
      const T Z0 = scal[0], e = scal[1], Zi = scal[2];
      const T g_e = g_Zi / Z0;
      const T g_lZk = scal[5] - g_e * e;
      const T g_raw = g_e * e + (scal[3] != T(0) ? g_lZk : T(0));
      const T g_Z0 = -g_Zi * Zi / Z0 + g_raw / Z0;
      const T gZ = (scal[4] != T(0) ? g_Z0 : T(0)) + g_Zd;
      T g_mu, g_s;
      st.match_vjp(yk, scal[6], gZ, g4, lkbar_w, wacc, gsn2, g_mu, g_s);
      if (chan) {
        g_fmu += g_mu;
        if (mod) {
          g_sd += g_s;  // sd = sqrt(max(var, 0))
          g_var += var >= T(0) ? T(0.5) * g_sd / sd : T(0);
        } else {
          g_var += g_s;
        }
      }
    }

    // ---- 1 backwards: fmu = (h'A) m0, var and Ph from the row it read -----
    if (chan) {
#pragma unroll
      for (int i = 0; i < BS; ++i) {
        psum[(size_t)(BB + i) * C + c] += (double)(g_fmu * m0[i]);
        T s = g_fmu * HA[i];
#pragma unroll
        for (int k = 0; k < BS; ++k) s += A[k][i] * m_bar[k];
        m0[i] = s;  // m0 is no longer needed: the cotangent of ms[t-1]
      }
      if (t > 0) {
        double* dst = gts + ((size_t)c * G + id_prev) * RW;
#pragma unroll
        for (int i = 0; i < BS; ++i) dst[i] += (double)g_Ph[i];
        dst[BS] += (double)g_var;
      } else {
#pragma unroll
        for (int i = 0; i < BS; ++i) va.gfirst[(size_t)c * RW + i] = g_Ph[i];
        va.gfirst[(size_t)c * RW + BS] = g_var;
      }
#pragma unroll
      for (int i = 0; i < BS; ++i) m_bar[i] = m0[i];
    }
  }

  // ---- the end: the float64 sums, in a fixed order ---------------------------
  sn2_part[tid] = gsn2;
  __syncthreads();
  if (tid == 0) {
    double s = 0.0;
    for (int i = 0; i < NT; ++i) s += sn2_part[i];
    *va.gsn2 = (T)s;
  }
  if (chan) {  // HA = H'A: A's cotangent gains H g_HA', H's is A g_HA
    double gHA[BS];
#pragma unroll
    for (int j = 0; j < BS; ++j) gHA[j] = psum[(size_t)(BB + j) * C + c];
#pragma unroll
    for (int i = 0; i < BS; ++i) {
      const double h = (double)va.H[(size_t)c * BS + i];
      double s = 0.0;
#pragma unroll
      for (int j = 0; j < BS; ++j) {
        va.gA[(size_t)c * BB + i * BS + j] = (T)(psum[(size_t)(i * BS + j) * C + c] + h * gHA[j]);
        s += (double)A[i][j] * gHA[j];
      }
      va.gH[(size_t)c * BS + i] = (T)s;
    }
  }
  for (size_t i = tid; i < n_tab; i += NT) va.gtab[i] = (T)gts[i];
  // W: each (d, n) is the sum over the lanes that own subband d, in order
  const int GL = st.L.G, GW = 32 / GL;
  for (int q = tid; q < D * N; q += NT) {
    const int d = q / N, n = q - d * N, g = d / DB, j = d - g * DB;
    const double* src = wacc + (size_t)(n * DB + j) * NT;
    double s = 0.0;
    for (int wp = 0; wp < ADF_NW; ++wp)
      for (int gr = 0; gr < GW; ++gr) s += src[wp * 32 + gr * GL + g];
    va.gW[q] = (T)s;
  }
}

template <typename T, int BS>
int launch_ihgp_adf_vjp(const void* y, const void* match, const void* obs, const void* tt_in,
                        const void* tn_in, const void* A, const void* H, const void* first,
                        const void* tab, const void* lk, const void* W, const void* xi,
                        const void* wn, const void* sn2, const void* ms, const void* idx,
                        const void* tt, const void* g_ms, const void* g_lZ, const void* g_tt,
                        const void* g_tn, double damp, double omd, double log_floor,
                        double sq_floor, int n_steps, int D, int N, int S, int G, int link_exp,
                        int sq, void* gA, void* gH, void* gfirst, void* gtab, void* gW,
                        void* gsn2, void* scratch, cudaStream_t st) {
  if (n_steps < 1 || G < 1 || D < 1 || N < 1 || S < 1 || D > ADF_MAX_WIDTH ||
      N > ADF_MAX_WIDTH || D + N > ADF_THREADS)
    return -2;
  const IhgpVjpLayout V = ihgp_vjp_layout(D, N, S, BS, G, sizeof(T));
  if (V.bytes > ADF_SMEM_MAX) return -2;
  void (*kern)(AdfCore<T>, IhgpVjpArgs<T>) = fused_ihgp_adf_vjp_kernel<T, BS>;
  if (V.bytes > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)V.bytes);
    if (e != cudaSuccess) return (int)e;
  }
  // the moment match's steps: obs & match, as the sweep's observed flags
  const AdfCore<T> core = adf_core<T>(y, match, W, xi, wn, sn2, damp, log_floor, sq_floor,
                                      n_steps, /*BF=*/1, D, N, S, link_exp, sq, nullptr);
  const IhgpVjpArgs<T> va{(const T*)A,     (const T*)H,     (const T*)first, (const T*)tab,
                          (const T*)lk,    (const T*)obs,   (const T*)tt_in, (const T*)tn_in,
                          (const T*)ms,    (const int*)idx, (const T*)tt,    (const T*)g_ms,
                          (const T*)g_lZ,  (const T*)g_tt,  (const T*)g_tn,  (T*)gA,
                          (T*)gH,          (T*)gfirst,      (T*)gtab,        (T*)gW,
                          (T*)gsn2,        (double*)scratch, (T)omd,         G};
  kern<<<1, ADF_THREADS, V.bytes, st>>>(core, va);
  return (int)cudaGetLastError();
}

}  // namespace

// The C entry point of one dtype: nsgp_fused_ihgp_adf_vjp_<SUFFIX>.  `match`
// is obs & match as 0/1, `obs` the observed flags, idx int32 (K5's);
// `scratch` holds nsgp_ihgp_adf_vjp_scratch(D, N, bs, G) float64 values.
#define NSGP_DEFINE_FUSED_IHGP_ADF_VJP(SUFFIX, T)                                               \
  extern "C" int nsgp_fused_ihgp_adf_vjp_##SUFFIX(                                              \
      int bs, const void* y, const void* match, const void* obs, const void* tt_in,             \
      const void* tn_in, const void* A, const void* H, const void* first, const void* tab,      \
      const void* lk, const void* W, const void* xi, const void* wn, const void* sn2,           \
      const void* ms, const void* idx, const void* tt, const void* g_ms, const void* g_lZ,      \
      const void* g_tt, const void* g_tn, double damp, double omd, double log_floor,            \
      double sq_floor, int n_steps, int D, int N, int S, int G, int link_exp, int sq, void* gA, \
      void* gH, void* gfirst, void* gtab, void* gW, void* gsn2, void* scratch, void* stream) {  \
    cudaStream_t st = (cudaStream_t)stream;                                                     \
    NSGP_DISPATCH_BS(launch_ihgp_adf_vjp, T, y, match, obs, tt_in, tn_in, A, H, first, tab, lk, \
                     W, xi, wn, sn2, ms, idx, tt, g_ms, g_lZ, g_tt, g_tn, damp, omd, log_floor, \
                     sq_floor, n_steps, D, N, S, G, link_exp, sq, gA, gH, gfirst, gtab, gW,     \
                     gsn2, scratch, st)                                                         \
  }
