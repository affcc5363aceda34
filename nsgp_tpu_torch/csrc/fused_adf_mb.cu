// Batched ADF forward sweep for Hopper (sm_90a): EP sweep 1 over BF signals.
//
//   fused_adf_mb_kernel  replaces pallas_kalman.py:_adf_kernel_mb  (K4)
//
// What it computes, per (file, step), is what the single-signal kernel (K3,
// fused_kalman.cu) computes: predict, cubature moment match at the predicted
// marginal with the raw-scale Z floor, damped clamped site from zero incoming
// sites, measurement update.  What differs:
//
// * A file is a CTA.  The grid is (BF,) and every per-file constant is indexed
//   by blockIdx.x: A, Q, Pinf (BF, C, bs, bs), H (BF, C, bs), W (BF, D, N),
//   sn2 (BF,).  Files share nothing but the unit sigma points, so any BF is
//   accepted and BF files keep BF SMs busy for the T-long recursion.  (The TPU
//   kernel packs the files onto one core's lanes and needs 0/1 selector
//   matmuls to reduce per file; none of that exists here.)
// * Each sigma point is evaluated once when s_chunk > 0: the S points are
//   taken in tiles of ADF_THREADS, one point a thread, and the K = 1 + 2D + 2N
//   totals (Z, A1[D], A2[D], G1[N], G2[N]) are kept under a running shift
//   m_run.  Per tile: evaluate, tile max mc (0 where it is not finite),
//   m_new = max(m_run, mc), totals *= exp(m_run - m_new), totals += the
//   tile's row sums at shift m_new.  The first tile is not rescaled; the
//   ragged last tile sums only its valid points, so the others contribute
//   exactly 0.  The rescale chunk of the kernel is always one tile: a thread's
//   shared columns hold one point, so that is the chunk size that needs no
//   second evaluation, and any s_chunk > 0 is rounded to it.  Every output is
//   a ratio in which the shift cancels, so the chunk size changes rounding
//   only.
// * s_chunk = 0 means one chunk of all S points: a max pass over all tiles,
//   then the totals at that fixed shift.  With S > ADF_THREADS this
//   evaluates every point twice, as K3 does.
// * A step whose sample is unobserved skips the cubature altogether (the
//   branch is uniform over the CTA): its sites are zero, lZ = 0 and the
//   update is a no-op.
//
// Bound: like K1-K3 this is a latency-bound recursion, one SM per file; at
// mixture width (D = 48, N = 9, S = 3973) the per-step cubature (S * D * N
// multiply-adds from shared memory, then K row sums per tile) dominates.
// Row sums run in a fixed order with no atomics: two runs give the same bits.
//
// Layouts at the kernel boundary, exactly T steps:
//   y, obs, lZ (T, BF)        tt, tn (T, BF, C)
//   ms (T, BF, C, bs)         Ps (T, BF, C, bs, bs)
// Viewed as (T, BF*C, ...) they are what K1 and K2 take.
//
// Build flags as fused_kalman.cu (never --use_fast_math).

#include "nsgp_common.cuh"

namespace {

// Block-wide maximum of v (plain '>' like K3: a NaN never wins, it poisons
// the sums instead).  Ends with the values in wmax readable by all threads;
// the caller keeps two barriers between successive calls.
template <typename T>
__device__ __forceinline__ T block_max(T v, T* __restrict__ wmax, int tid) {
  constexpr int NW = ADF_THREADS / 32;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const T o = __shfl_xor_sync(0xffffffffu, v, off);
    v = o > v ? o : v;
  }
  if ((tid & 31) == 0) wmax[tid >> 5] = v;
  __syncthreads();
  v = wmax[0];
#pragma unroll
  for (int w = 1; w < NW; ++w) v = wmax[w] > v ? wmax[w] : v;
  return v;
}

template <typename T, int BS>
__global__ void __launch_bounds__(ADF_THREADS)
fused_adf_mb_kernel(const T* __restrict__ y, const T* __restrict__ obs,
                    const T* __restrict__ A_, const T* __restrict__ Q_,
                    const T* __restrict__ Pinf_, const T* __restrict__ H_,
                    const T* __restrict__ W_, const T* __restrict__ xi,
                    const T* __restrict__ wn, const T* __restrict__ sn2_,
                    T damp, T log_floor, int n_steps, int BF, int D, int N, int S,
                    int online_i, int link_exp_i, int sq_i, T* __restrict__ ms,
                    T* __restrict__ Ps, T* __restrict__ lZ, T* __restrict__ tt_out,
                    T* __restrict__ tn_out) {
  constexpr int NT = ADF_THREADS, PITCH = ADF_PITCH;
  constexpr int NW = NT / 32;
  const int tid = threadIdx.x;
  const int b = blockIdx.x;  // the file
  const int C = D + N;
  const int K = 1 + 2 * D + 2 * N;
  const bool link_exp = link_exp_i != 0, sq = sq_i != 0;
  const bool one_tile = S <= NT;
  const bool online = online_i != 0;
  // Points are evaluated inside the tile loop unless the max pass of the
  // single-chunk mode already left the only tile in the shared columns.
  const bool eval_in_loop = online || !one_tile;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* fmu_sh = reinterpret_cast<T*>(smem_raw);
  T* hph_sh = fmu_sh + C;
  T* sd_sh = hph_sh + C;
  T* wmax = sd_sh + N;
  T* tot = wmax + NW;
  T* terms = tot + K;                           // terms[k * PITCH + tid]
  T* xn_col = terms + (size_t)K * PITCH + tid;  // xn_col[n * NT]
  T* lk_col = xn_col + (size_t)N * NT;          // lk_col[n * NT]
  T* a_col = lk_col + (size_t)N * NT;           // a_col[d * NT]
  T* W_sh = a_col - tid + (size_t)D * NT;
  T* slot = terms + tid;

  const T* W = W_ + (size_t)b * D * N;
  for (int i = tid; i < D * N; i += NT) W_sh[i] = W[i];
  const T sn2 = sn2_[b];

  // Channel state (threads tid < C only); ch = this file's channel.
  const bool chan = tid < C;
  const size_t ch = (size_t)b * C + tid;
  T A[BS][BS], Q[BS][BS], P[BS][BS], H[BS], m[BS];
  if (chan) {
    load_mat<T, BS>(A, A_ + ch * BS * BS);
    load_mat<T, BS>(Q, Q_ + ch * BS * BS);
    load_mat<T, BS>(P, Pinf_ + ch * BS * BS);
#pragma unroll
    for (int i = 0; i < BS; ++i) {
      H[i] = H_[ch * BS + i];
      m[i] = T(0);
    }
  }
  T y_next = y[b], obs_next = obs[b];

  for (int t = 0; t < n_steps; ++t) {
    const T yk = y_next;
    const bool observed = obs_next > T(0);  // uniform over the CTA
    if (t + 1 < n_steps) {
      y_next = y[(size_t)(t + 1) * BF + b];
      obs_next = obs[(size_t)(t + 1) * BF + b];
    }

    // ---- 1. predict and publish the observable marginals ----------------
    T mp[BS], Pp[BS][BS], PH[BS], fmu = T(0), HPH = T(0);
    if (chan) {
      T AP[BS][BS];
      predict<T, BS>(A, Q, m, P, mp, AP, Pp);
      observe<T, BS>(H, mp, Pp, fmu, PH, HPH);
      if (observed) {
        fmu_sh[tid] = fmu;
        hph_sh[tid] = HPH;
        if (tid >= D) sd_sh[tid - D] = Num<T>::sqrt_(clamp_min(HPH, T(0)));
      }
    }

    T m_run = -INFINITY;
    if (observed) {
      __syncthreads();

      // ---- 2. single-chunk mode: the shift is the max over all S --------
      T s2e = T(0), resid = T(0), ln = T(0);
      T m_fixed = T(0);
      if (!online) {
        T lmax = -INFINITY;
        for (int s0 = 0; s0 < S; s0 += NT) {
          const int s = s0 + tid;
          if (s < S) {
            eval_sigma<T>(s, xi, fmu_sh, hph_sh, sd_sh, W_sh, xn_col, lk_col, a_col, yk, sn2,
                          D, N, link_exp, sq, s2e, resid, ln);
            lmax = ln > lmax ? ln : lmax;
          }
        }
        m_fixed = block_max<T>(lmax, wmax, tid);
        if (!Num<T>::finite(m_fixed)) m_fixed = T(0);
      }

      // ---- 3. tiles: shifted moment sums in a fixed order ---------------
      for (int s0 = 0; s0 < S; s0 += NT) {
        const int s = s0 + tid;
        const bool valid = s < S;
        if (valid && eval_in_loop)
          eval_sigma<T>(s, xi, fmu_sh, hph_sh, sd_sh, W_sh, xn_col, lk_col, a_col, yk, sn2, D,
                        N, link_exp, sq, s2e, resid, ln);
        T m_new = m_fixed;
        if (online) {
          T mc = block_max<T>(valid ? ln : T(-INFINITY), wmax, tid);
          if (!Num<T>::finite(mc)) mc = T(0);
          m_new = m_run > mc ? m_run : mc;
        }
        // rescale of the totals so far; the first tile has none
        const T al = s0 == 0 ? T(0) : Num<T>::exp_(m_run - m_new);
        if (valid) {
          const T wns = wn[s] * Num<T>::exp_(ln - m_new);
          const T rs = resid / s2e;
          const T c2 = rs * rs - T(1) / s2e;
          slot[0] = wns;
          for (int d = 0; d < D; ++d) {
            const T ad = a_col[d * NT];
            slot[(1 + d) * PITCH] = wns * rs * ad;
            slot[(1 + D + d) * PITCH] = wns * (ad * ad) * c2;
          }
          for (int n = 0; n < N; ++n) {
            const T mu_g = fmu_sh[D + n], s2_g = hph_sh[D + n];
            const T dmu = (xn_col[n * NT] - mu_g) / s2_g;
            slot[(1 + 2 * D + n) * PITCH] = wns * dmu;
            slot[(1 + 2 * D + N + n) * PITCH] = wns * (dmu * dmu - T(1) / s2_g);
          }
        }
        __syncthreads();
        const int ns = min(S - s0, NT);  // valid sigma points in this tile
        for (int k = tid; k < K; k += NT) {  // K may exceed the thread count
          const T* row = terms + (size_t)k * PITCH;
          T acc0 = T(0), acc1 = T(0), acc2 = T(0), acc3 = T(0);
          int j = 0;
          for (; j + 4 <= ns; j += 4) {
            acc0 += row[j];
            acc1 += row[j + 1];
            acc2 += row[j + 2];
            acc3 += row[j + 3];
          }
          for (; j < ns; ++j) acc0 += row[j];
          const T sum = (acc0 + acc1) + (acc2 + acc3);
          tot[k] = s0 == 0 ? sum : tot[k] * al + sum;
        }
        m_run = m_new;
        __syncthreads();
      }
    }

    // ---- 4. derivatives, damped site, measurement update -----------------
    if (chan) {
      T tt = T(0), tn = T(0), lZk = T(0);  // unobserved: zero sites, lZ = 0
      if (observed) {
        const T Z0 = clamp_min(tot[0], Num<T>::tiny());
        const T lZ_raw = m_run + Num<T>::log_(Z0);
        lZk = clamp_min(lZ_raw, log_floor);  // floor on the raw sum, not the shifted
        const T Zi = Num<T>::exp_(lZ_raw - lZk) / Z0;
        const int k1 = tid < D ? 1 + tid : 1 + 2 * D + (tid - D);
        const int k2 = tid < D ? 1 + D + tid : 1 + 2 * D + N + (tid - D);
        const T dl = Zi * tot[k1];
        const T d2 = Zi * tot[k2] - dl * dl;
        const T denom = T(1) + d2 * HPH;
        // incoming sites are zero: (1 - damp) * 0 + damp * (...)
        tt = clamp_min(damp * (-d2 / denom), T(0));
        tn = damp * ((dl - fmu * d2) / denom);
      }
      const size_t row = ((size_t)t * BF + b) * C + tid;
      tt_out[row] = tt;
      tn_out[row] = tn;
      if (tid == 0) lZ[(size_t)t * BF + b] = lZk;
      site_update<T, BS>(tt, tn, fmu, HPH, PH, mp, Pp, m, P);
#pragma unroll
      for (int i = 0; i < BS; ++i) ms[row * BS + i] = m[i];
      store_mat<T, BS>(Ps + row * BS * BS, P);
    }
  }
}

template <typename T, int BS>
int launch_adf_mb(const void* y, const void* obs, const void* A, const void* Q,
                  const void* Pinf, const void* H, const void* W, const void* xi,
                  const void* wn, const void* sn2, double damp, double log_floor,
                  int n_steps, int BF, int D, int N, int S, int online, int link_exp, int sq,
                  void* ms, void* Ps, void* lZ, void* tt, void* tn, cudaStream_t st) {
  if (D + N > ADF_THREADS) return -2;  // one thread per channel
  const size_t bytes = adf_smem_elems(D + N, D, N) * sizeof(T);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_adf_mb_kernel<T, BS>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  fused_adf_mb_kernel<T, BS><<<BF, ADF_THREADS, bytes, st>>>(
      (const T*)y, (const T*)obs, (const T*)A, (const T*)Q, (const T*)Pinf, (const T*)H,
      (const T*)W, (const T*)xi, (const T*)wn, (const T*)sn2, (T)damp, (T)log_floor,
      n_steps, BF, D, N, S, online, link_exp, sq, (T*)ms, (T*)Ps, (T*)lZ, (T*)tt, (T*)tn);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int nsgp_adf_threads() { return ADF_THREADS; }

int nsgp_fused_adf_mb(int is_f64, int bs, const void* y, const void* obs, const void* A,
                      const void* Q, const void* Pinf, const void* H, const void* W,
                      const void* xi, const void* wn, const void* sn2, double damp,
                      double log_floor, int n_steps, int BF, int D, int N, int S, int online,
                      int link_exp, int sq, void* ms, void* Ps, void* lZ, void* tt, void* tn,
                      void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  NSGP_DISPATCH(launch_adf_mb, y, obs, A, Q, Pinf, H, W, xi, wn, sn2, damp, log_floor,
                n_steps, BF, D, N, S, online, link_exp, sq, ms, Ps, lZ, tt, tn, st)
}

}  // extern "C"
