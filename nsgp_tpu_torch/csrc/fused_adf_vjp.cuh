// The reverse of K3's ADF sweep for Hopper (sm_90a): the vector-Jacobian
// product of EP sweep 1, the backward of fused_kalman.FusedADF.
//
//   fused_adf_vjp_kernel  counterpart of the transposed scan that
//                         jax.value_and_grad derives from the lax.scan of
//                         nsgp_tpu/ops/kalman.py:adf_filter  (K7)
//
// In: K3's inputs, its filtered ms (T, C, bs), Ps (T, C, bs, bs) and the
// cotangents of its five outputs (a null pointer is a zero cotangent).  Out:
// the cotangents of A, Q, Pinf (C, bs, bs), H (C, bs), W (D, N) and sn2.
//
// What bounds it.  Like K3, a T-long recursion, now walked from t = T-1 down
// to 0: the cotangent of step t's filtered state is needed before step t-1
// can start.  Bytes (ms and Ps read once) and operations are orders of
// magnitude below the card's rates; what counts is the latency of a reverse
// step on one SM.
//
// What the design does about it.
//
// * Recompute, no stash.  Step t is re-derived from the stored (ms, Ps)[t-1]
//   ((0, Pinf) at t = 0): the prediction by the channel threads, then the
//   moment match by adf_step.cuh's own match (K3's thread map and code, so
//   the totals are the forward's), then the reverse pass over the points
//   (match_vjp, one pass: every point re-evaluated at the merged shift).
//   K3, K4 and K5 keep their code and their outputs; the reverse costs one
//   extra pass over the points a step.
// * One CTA of ADF_THREADS, K3's thread map: channel threads for the
//   per-channel bs x bs algebra (the reverse of the update, the site, the
//   derivatives of log Z, the observation and the prediction), lane groups
//   over the sigma points, W transposed and padded, xi / wn staged once.  Any
//   S that K3 takes: the points are walked in rounds inside the CTA (no
//   cluster), so a mixture-width model gets its gradient too, slowly.
// * Four block barriers a matched step: the two of match, one after the
//   channel threads publish the cotangents of the totals (Z's gathers a
//   sum over the channels, taken in channel order by every thread), one
//   after match_vjp's merge of the lanes' sums.
// * Parameter cotangents summed over T in float64 whatever T is: A, Q, H
//   per channel, W per lane (its DB subbands x N modulators), sn2 per
//   group; in shared memory where they fit, else in the wrapper's scratch,
//   each sum owned by one thread.  One fixed-order reduction at the end.  No
//   atomics: two runs give the same bits.
// * The max shift is a constant (it carries no gradient), the clamps pass
//   the cotangent where they do not bind (x >= bound, as torch's clamp_min):
//   sqrt(max(s2_g, 0)), the 'sq' amplitude's floor, tt >= 0, the raw-scale
//   Z floor and Z's tiny floor.  Unobserved steps have zero sites and lZ = 0:
//   their cotangent runs through the prediction alone.
//
// fused_kalman.fused_adf_vjp_plain is the plain version, in this step order.
// Build flags as fused_kalman.cuh (never --use_fast_math); compiled once per
// dtype, by fused_adf_vjp_f32.cu and fused_adf_vjp_f64.cu.

#pragma once

#include "adf_step.cuh"

namespace {

template <typename T>
struct VjpArgs {
  const T* A;
  const T* Q;
  const T* Pinf;
  const T* H;
  const T* ms;
  const T* Ps;
  const T* g_ms;  // the cotangents of K3's outputs, null = zero
  const T* g_Ps;
  const T* g_lZ;
  const T* g_tt;
  const T* g_tn;
  T* gA;
  T* gQ;
  T* gPinf;
  T* gH;
  T* gW;
  T* gsn2;
  double* scratch;  // the float64 sums where shared memory cannot hold them
};

// K7's shared memory after the sweep's layout: offsets in elements of T,
// then the float64 part from byte `dbl` (the sn2 partials, then the sums if
// they fit: npar a channel, [npar][C], then W's [N][DB][threads]).
struct VjpLayout {
  int g4, zi, zd, scal, lkbar;
  size_t dbl;
  int npar, nw, sums_shared;
  size_t bytes;
};

__host__ __device__ inline VjpLayout vjp_layout(int D, int N, int S, int BS, size_t elem) {
  const AdfLayout L = adf_layout(D, N, S, 1, elem);
  VjpLayout V;
  int o = L.total;
  V.g4 = o; o += 4 * L.Dp;  // the totals' cotangents: A1, A2, X1, X2
  V.zi = o; o += adf_r4(D + N);  // each channel's share of Zi's and Z's
  V.zd = o; o += adf_r4(D + N);
  V.scal = o; o += 8;  // the step's scalars, from channel 0
  V.lkbar = o; o += adf_r4(ADF_NW * N * L.PT);  // the warps' link cotangents
  V.dbl = ((size_t)o * elem + 15) & ~(size_t)15;
  V.npar = 2 * BS * BS + BS;
  V.nw = N * ADF_DB * ADF_THREADS;
  const size_t sums = ((size_t)(D + N) * V.npar + V.nw) * sizeof(double);
  const size_t base = V.dbl + ADF_THREADS * sizeof(double);
  V.sums_shared = base + sums <= ADF_SMEM_MAX;
  V.bytes = base + (V.sums_shared ? sums : 0);
  return V;
}

// float64 sums the wrapper's scratch must hold: the same as in shared memory.
__host__ inline size_t vjp_scratch_doubles(int D, int N, int BS) {
  return (size_t)(D + N) * (2 * BS * BS + BS) + (size_t)N * ADF_DB * ADF_THREADS;
}

// Channel c's filtered state after step t - 1: (ms, Ps)[t-1], or (0, Pinf).
template <typename T, int BS>
__device__ __forceinline__ void vjp_previous(const VjpArgs<T>& va, int t, int c, int C,
                                             T (&m0)[BS], T (&P0)[BS][BS]) {
  if (t > 0) {
    const size_t row = (size_t)(t - 1) * C + c;
#pragma unroll
    for (int i = 0; i < BS; ++i) m0[i] = va.ms[row * BS + i];
    load_mat<T, BS>(P0, va.Ps + row * BS * BS);
  } else {
#pragma unroll
    for (int i = 0; i < BS; ++i) m0[i] = T(0);
    load_mat<T, BS>(P0, va.Pinf + (size_t)c * BS * BS);
  }
}

template <typename T, int BS>
__global__ void __launch_bounds__(ADF_THREADS, 1)
fused_adf_vjp_kernel(AdfCore<T> core, VjpArgs<T> va) {
  constexpr int NT = ADF_THREADS, PB = ADF_PB_ONE, DB = ADF_DB, BB = BS * BS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sh = reinterpret_cast<T*>(smem_raw);
  const AdfStep<T, PB> st(core, 0, 1, sh);
  const int D = core.D, N = core.N, C = D + N, Dp = st.L.Dp;
  const VjpLayout V = vjp_layout(D, N, core.S, BS, sizeof(T));
  const int tid = st.tid, c = tid, own = st.own;
  const bool chan = st.chan, mod = tid >= D;
  T* g4 = sh + V.g4;
  T* zi = sh + V.zi;
  T* zd = sh + V.zd;
  T* scal = sh + V.scal;
  T* lkbar_w = sh + V.lkbar + st.w * N * st.L.PT;
  double* sn2_part = reinterpret_cast<double*>(smem_raw + V.dbl);
  double* psum = V.sums_shared ? sn2_part + NT : va.scratch;  // [npar][C]: A, Q, H
  double* wacc = psum + (size_t)C * V.npar;                  // [N][DB][NT]
  for (int i = tid; i < C * V.npar + V.nw; i += NT) psum[i] = 0.0;
  for (int i = tid; i < 4 * Dp; i += NT) g4[i] = T(0);
  const T tiny = Num<T>::tiny(), log_floor = core.log_floor, damp = core.damp;
  T m_bar[BS], P_bar[BS][BS];  // cotangents of step t's filtered state
#pragma unroll
  for (int i = 0; i < BS; ++i) {
    m_bar[i] = T(0);
#pragma unroll
    for (int j = 0; j < BS; ++j) P_bar[i][j] = T(0);
  }
  double gsn2 = 0.0;
  AdfProbe probe(false);
  T y_next = core.y[core.n_steps - 1], obs_next = core.obs[core.n_steps - 1];
  __syncthreads();

  for (int t = core.n_steps - 1; t >= 0; --t) {
    const T yk = y_next;
    const bool observed = obs_next > T(0);  // uniform over the CTA
    if (t > 0) {
      y_next = core.y[t - 1];
      obs_next = core.obs[t - 1];
    }

    // ---- 1. re-derive step t's prediction and marginal ---------------------
    T fmu = T(0), var = T(0), sd = T(0), PH[BS];
    if (chan) {
      T A[BS][BS], Q[BS][BS], H[BS], m0[BS], P0[BS][BS], mp[BS], AP[BS][BS], Pp[BS][BS];
      load_mat<T, BS>(A, va.A + (size_t)c * BB);
      load_mat<T, BS>(Q, va.Q + (size_t)c * BB);
#pragma unroll
      for (int i = 0; i < BS; ++i) H[i] = va.H[(size_t)c * BS + i];
      vjp_previous<T, BS>(va, t, c, C, m0, P0);
      predict<T, BS>(A, Q, m0, P0, mp, AP, Pp);
      observe<T, BS>(H, mp, Pp, fmu, PH, var);
      if (observed) st.publish(fmu, var, sd);
      const size_t row = (size_t)t * C + c;
      if (va.g_ms) {
#pragma unroll
        for (int i = 0; i < BS; ++i) m_bar[i] += va.g_ms[row * BS + i];
      }
      if (va.g_Ps) {
#pragma unroll
        for (int i = 0; i < BS; ++i)
#pragma unroll
          for (int j = 0; j < BS; ++j) P_bar[i][j] += va.g_Ps[row * BB + i * BS + j];
      }
    }

    // ---- 2, 3. re-derive the totals of the sigma points (K3's code) ---------
    T tot[3] = {T(0), T(0), T(0)}, m_all = T(0);
    if (observed) st.match(yk, 0, tot, m_all, probe);

    // ---- 4 backwards: the update, the site, the derivatives of log Z -------
    T g_fmu = T(0), g_var = T(0), g_sd = T(0), g_PH[BS];
    if (chan) {
      // step t forwards from the totals, as K3's adf_derivatives and advance
      const T mall = Num<T>::finite(m_all) ? m_all : T(0);
      const T Z = tot[0], X1 = tot[1], X2 = tot[2];
      T S1 = X1, S2 = X2, is2 = T(0), rg = T(0), Z0 = T(1), lZ_raw = T(0), e = T(1);
      T Zi = T(0), dl = T(0), d2 = T(0), denom = T(1), r = T(0), tt = T(0), tn = T(0);
      if (observed) {
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
        tt = clamp_min(damp * r, T(0));
        tn = damp * ((dl - fmu * d2) / denom);
      }
      // m = mp - PH v, P = Pp - w PH PH' backwards (m_bar, P_bar become the
      // prediction's cotangents)
      const T z = tt * var + T(1), v = (tt * fmu - tn) / z, w = tt / z;
      T g_v = T(0), g_w = T(0);
#pragma unroll
      for (int i = 0; i < BS; ++i) {
        T s = T(0);
#pragma unroll
        for (int j = 0; j < BS; ++j) {
          s += (P_bar[i][j] + P_bar[j][i]) * PH[j];
          g_w -= P_bar[i][j] * PH[i] * PH[j];
        }
        g_PH[i] = -v * m_bar[i] - w * s;
        g_v -= PH[i] * m_bar[i];
      }
      const T g_z = -(g_v * v + g_w * w) / z;
      g_fmu = g_v * tt / z;
      g_var = g_z * tt;
      if (observed) {
        const size_t row = (size_t)t * C + c;
        const T g_tt = (va.g_tt ? va.g_tt[row] : T(0)) + (g_v * fmu + g_w) / z + g_z * var;
        const T g_tn = (va.g_tn ? va.g_tn[row] : T(0)) - g_v / z;
        // tt = max(damp r, 0), r = -d2 / denom, tn = damp (dl - fmu d2) / denom
        const T g_r = damp * r >= T(0) ? damp * g_tt : T(0);
        const T g_den = -(g_tn * tn + g_r * r) / denom;
        T g_dl = damp * g_tn / denom;
        const T g_d2 = -damp * g_tn * fmu / denom - g_r / denom + g_den * var;
        g_fmu -= damp * g_tn * d2 / denom;
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
    if (observed) {
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

    // ---- 1 backwards: the observation and the prediction -------------------
    if (chan) {
      T A[BS][BS], Q[BS][BS], H[BS], m0[BS], P0[BS][BS], mp[BS], AP[BS][BS], Pp[BS][BS];
      load_mat<T, BS>(A, va.A + (size_t)c * BB);
      load_mat<T, BS>(Q, va.Q + (size_t)c * BB);
#pragma unroll
      for (int i = 0; i < BS; ++i) H[i] = va.H[(size_t)c * BS + i];
      vjp_previous<T, BS>(va, t, c, C, m0, P0);
      predict<T, BS>(A, Q, m0, P0, mp, AP, Pp);
      // fmu = H mp, PH = Pp H, var = H' PH
      T g_mp[BS], g_Pp[BS][BS];
#pragma unroll
      for (int i = 0; i < BS; ++i) g_PH[i] += g_var * H[i];
#pragma unroll
      for (int j = 0; j < BS; ++j) {
        T s = g_var * PH[j] + g_fmu * mp[j];
#pragma unroll
        for (int i = 0; i < BS; ++i) s += g_PH[i] * Pp[i][j];
        psum[(size_t)(2 * BB + j) * C + c] += (double)s;
        g_mp[j] = m_bar[j] + g_fmu * H[j];
      }
#pragma unroll
      for (int i = 0; i < BS; ++i)
#pragma unroll
        for (int j = 0; j < BS; ++j) g_Pp[i][j] = P_bar[i][j] + g_PH[i] * H[j];
      // mp = A m0, AP = A P0, Pp = AP A' + Q
      T g_AP[BS][BS];
#pragma unroll
      for (int i = 0; i < BS; ++i)
#pragma unroll
        for (int j = 0; j < BS; ++j) {
          T s = T(0);
#pragma unroll
          for (int k = 0; k < BS; ++k) s += g_Pp[i][k] * A[k][j];
          g_AP[i][j] = s;
        }
#pragma unroll
      for (int i = 0; i < BS; ++i)
#pragma unroll
        for (int j = 0; j < BS; ++j) {
          T s = g_mp[i] * m0[j];
#pragma unroll
          for (int k = 0; k < BS; ++k) s += g_Pp[k][i] * AP[k][j] + g_AP[i][k] * P0[j][k];
          psum[(size_t)(i * BS + j) * C + c] += (double)s;
          psum[(size_t)(BB + i * BS + j) * C + c] += (double)g_Pp[i][j];
        }
#pragma unroll
      for (int i = 0; i < BS; ++i) {
        T s = T(0);
#pragma unroll
        for (int k = 0; k < BS; ++k) s += A[k][i] * g_mp[k];
        m_bar[i] = s;
#pragma unroll
        for (int j = 0; j < BS; ++j) {
          T q = T(0);
#pragma unroll
          for (int k = 0; k < BS; ++k) q += A[k][i] * g_AP[k][j];
          P_bar[i][j] = q;
        }
      }
    }
  }

  // ---- the end: Pinf's cotangent is P_bar at step 0; the float64 sums -----
  sn2_part[tid] = gsn2;
  __syncthreads();
  if (tid == 0) {
    double s = 0.0;
    for (int i = 0; i < NT; ++i) s += sn2_part[i];
    *va.gsn2 = (T)s;
  }
  if (chan) {
    store_mat<T, BS>(va.gPinf + (size_t)c * BB, P_bar);
#pragma unroll
    for (int k = 0; k < BB; ++k) {
      va.gA[(size_t)c * BB + k] = (T)psum[(size_t)k * C + c];
      va.gQ[(size_t)c * BB + k] = (T)psum[(size_t)(BB + k) * C + c];
    }
#pragma unroll
    for (int k = 0; k < BS; ++k) va.gH[(size_t)c * BS + k] = (T)psum[(size_t)(2 * BB + k) * C + c];
  }
  // W: each (d, n) is the sum over the lanes that own subband d, in order
  const int G = st.L.G, GW = 32 / G;
  for (int q = tid; q < D * N; q += NT) {
    const int d = q / N, n = q - d * N, g = d / DB, j = d - g * DB;
    const double* src = wacc + (size_t)(n * DB + j) * NT;
    double s = 0.0;
    for (int wp = 0; wp < ADF_NW; ++wp)
      for (int gr = 0; gr < GW; ++gr) s += src[wp * 32 + gr * G + g];
    va.gW[q] = (T)s;
  }
}

template <typename T, int BS>
int launch_adf_vjp(const void* y, const void* obs, const void* A, const void* Q,
                   const void* Pinf, const void* H, const void* W, const void* xi,
                   const void* wn, const void* sn2, const void* ms, const void* Ps,
                   const void* g_ms, const void* g_Ps, const void* g_lZ, const void* g_tt,
                   const void* g_tn, double damp, double log_floor, int n_steps, int D, int N,
                   int S, int link_exp, int sq, void* gA, void* gQ, void* gPinf, void* gH,
                   void* gW, void* gsn2, void* scratch, cudaStream_t st) {
  if (n_steps < 1 || D < 1 || N < 1 || S < 1 || D > ADF_MAX_WIDTH || N > ADF_MAX_WIDTH ||
      D + N > ADF_THREADS)
    return -2;
  const VjpLayout V = vjp_layout(D, N, S, BS, sizeof(T));
  if (V.bytes > ADF_SMEM_MAX) return -2;
  void (*kern)(AdfCore<T>, VjpArgs<T>) = fused_adf_vjp_kernel<T, BS>;
  if (V.bytes > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)V.bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const AdfCore<T> core = adf_core<T>(y, obs, W, xi, wn, sn2, damp, log_floor, ADF_SQ_FLOOR,
                                      n_steps, /*BF=*/1, D, N, S, link_exp, sq, nullptr);
  const VjpArgs<T> va{(const T*)A,    (const T*)Q,    (const T*)Pinf, (const T*)H,
                      (const T*)ms,   (const T*)Ps,   (const T*)g_ms, (const T*)g_Ps,
                      (const T*)g_lZ, (const T*)g_tt, (const T*)g_tn, (T*)gA,
                      (T*)gQ,         (T*)gPinf,      (T*)gH,         (T*)gW,
                      (T*)gsn2,       (double*)scratch};
  kern<<<1, ADF_THREADS, V.bytes, st>>>(core, va);
  return (int)cudaGetLastError();
}

}  // namespace

// The C entry point of one dtype: nsgp_fused_adf_vjp_<SUFFIX>.  `scratch`
// holds nsgp_adf_vjp_scratch(D, N, bs) float64 values.
#define NSGP_DEFINE_FUSED_ADF_VJP(SUFFIX, T)                                                    \
  extern "C" int nsgp_fused_adf_vjp_##SUFFIX(                                                   \
      int bs, const void* y, const void* obs, const void* A, const void* Q, const void* Pinf,   \
      const void* H, const void* W, const void* xi, const void* wn, const void* sn2,            \
      const void* ms, const void* Ps, const void* g_ms, const void* g_Ps, const void* g_lZ,     \
      const void* g_tt, const void* g_tn, double damp, double log_floor, int n_steps, int D,    \
      int N, int S, int link_exp, int sq, void* gA, void* gQ, void* gPinf, void* gH, void* gW,  \
      void* gsn2, void* scratch, void* stream) {                                                \
    cudaStream_t st = (cudaStream_t)stream;                                                     \
    NSGP_DISPATCH_BS(launch_adf_vjp, T, y, obs, A, Q, Pinf, H, W, xi, wn, sn2, ms, Ps, g_ms,    \
                     g_Ps, g_lZ, g_tt, g_tn, damp, log_floor, n_steps, D, N, S, link_exp, sq,   \
                     gA, gQ, gPinf, gH, gW, gsn2, scratch, st)                                  \
  }
