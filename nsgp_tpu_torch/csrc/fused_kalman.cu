// Fused Kalman filter / RTS smoother / ADF kernels for Hopper (sm_90a).
//
// Hand-written CUDA counterparts of the three Pallas kernels on the GT-NMF
// Power-EP path (nsgp_tpu/ops/pallas_kalman.py):
//
//   fused_fwd_kernel  replaces pallas_kalman.py:_fwd_kernel  (K1)
//   fused_bwd_kernel  replaces pallas_kalman.py:_bwd_kernel  (K2)
//   fused_adf_kernel  replaces pallas_kalman.py:_adf_kernel  (K3)
//
// Each is a sequential recursion over T with a tiny per-channel state
// (bs + bs*bs <= 72 values, bs <= 8): one thread carries one channel's m and P
// in registers for the whole time loop, and the loop over T runs inside the
// kernel, so a pass is one launch.  What bounds them on this card is the
// latency of the dependent per-step chain (predict -> marginals -> update,
// plus the block-wide sigma-point reductions in K3), not bytes or FLOPs: a
// pass uses one SM of 132.  Filling the card (several signals per launch) is
// the batched kernel's work.  Loads of the next step's inputs are issued one
// step ahead so their latency overlaps the current step's arithmetic.
//
// Layouts (C-major, what inference/ep.py consumes; no padding of T):
//   sites, lZ    (T, C) / (T,)          A, Q, Pinf (C, bs, bs)   H, pad (C, bs)
//   ms           (T, C, bs)             Ps         (T, C, bs, bs)
//   W            (D, N)                 xi (S, N), wn (S,)
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC.  Never with --use_fast_math: ~4e-3 relative error
// in the residual y - mean (catastrophic cancellation once sites converge)
// diverged the EP sweeps by sweep 3 on the TPU.
//
// Every entry point launches on the given stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError() (or -1 for an
// unsupported block size / dtype).

#include "nsgp_common.cuh"

namespace {

// ---------------------------------------------------------------------------
// K1: forward filter with fixed sites
// ---------------------------------------------------------------------------

template <typename T, int BS>
__global__ void fused_fwd_kernel(const T* __restrict__ ttau, const T* __restrict__ tnu,
                                 const T* __restrict__ A_, const T* __restrict__ Q_,
                                 const T* __restrict__ Pinf_, const T* __restrict__ H_,
                                 T* __restrict__ ms, T* __restrict__ Ps, int n_steps,
                                 int C) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  T A[BS][BS], Q[BS][BS], P[BS][BS], H[BS], m[BS];
  load_mat<T, BS>(A, A_ + c * BS * BS);
  load_mat<T, BS>(Q, Q_ + c * BS * BS);
  load_mat<T, BS>(P, Pinf_ + c * BS * BS);  // start from (0, Pinf)
#pragma unroll
  for (int i = 0; i < BS; ++i) {
    H[i] = H_[c * BS + i];
    m[i] = T(0);
  }
  T tt_next = ttau[c], tn_next = tnu[c];
  for (int t = 0; t < n_steps; ++t) {
    const T tt = tt_next, tn = tn_next;
    if (t + 1 < n_steps) {
      tt_next = ttau[(size_t)(t + 1) * C + c];
      tn_next = tnu[(size_t)(t + 1) * C + c];
    }
    // Predict at every step, the first included: from (0, Pinf) with the
    // stationary Q = Pinf - A Pinf A' that is an exact no-op.
    T mp[BS], AP[BS][BS], Pp[BS][BS], PH[BS], fmu, HPH;
    predict<T, BS>(A, Q, m, P, mp, AP, Pp);
    observe<T, BS>(H, mp, Pp, fmu, PH, HPH);
    site_update<T, BS>(tt, tn, fmu, HPH, PH, mp, Pp, m, P);
    const size_t row = (size_t)t * C + c;
#pragma unroll
    for (int i = 0; i < BS; ++i) ms[row * BS + i] = m[i];
    store_mat<T, BS>(Ps + row * BS * BS, P);
  }
}

// ---------------------------------------------------------------------------
// K2: RTS smoother over a stored filtered trajectory
// ---------------------------------------------------------------------------

template <typename T, int BS>
__global__ void fused_bwd_kernel(const T* __restrict__ ms, const T* __restrict__ Ps,
                                 const T* __restrict__ A_, const T* __restrict__ Q_,
                                 const T* __restrict__ pad_, T* __restrict__ sm,
                                 T* __restrict__ sP, int n_steps, int C) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  T A[BS][BS], Q[BS][BS], pad[BS];
  load_mat<T, BS>(A, A_ + c * BS * BS);
  load_mat<T, BS>(Q, Q_ + c * BS * BS);
#pragma unroll
  for (int i = 0; i < BS; ++i) pad[i] = pad_[c * BS + i];

  // Filtered moments of step t, loaded one step ahead.
  T m_nx[BS], P_nx[BS][BS];
  {
    const size_t row = (size_t)(n_steps - 1) * C + c;
#pragma unroll
    for (int i = 0; i < BS; ++i) m_nx[i] = ms[row * BS + i];
    load_mat<T, BS>(P_nx, Ps + row * BS * BS);
  }
  // Carry initialised so the last step's smoothed moments equal its
  // filtered ones: m_next = A m_L, P_next = A P_L A' + Q.
  T mn[BS], Pn[BS][BS];
  {
    T AP[BS][BS];
    predict<T, BS>(A, Q, m_nx, P_nx, mn, AP, Pn);
  }

  for (int t = n_steps - 1; t >= 0; --t) {
    const size_t row = (size_t)t * C + c;
    T m[BS], P[BS][BS];
#pragma unroll
    for (int i = 0; i < BS; ++i) m[i] = m_nx[i];
#pragma unroll
    for (int i = 0; i < BS; ++i)
#pragma unroll
      for (int k = 0; k < BS; ++k) P[i][k] = P_nx[i][k];
    if (t > 0) {
      const size_t prev = row - C;
#pragma unroll
      for (int i = 0; i < BS; ++i) m_nx[i] = ms[prev * BS + i];
      load_mat<T, BS>(P_nx, Ps + prev * BS * BS);
    }

    T Am[BS], AP[BS][BS], Pp[BS][BS];
    predict<T, BS>(A, Q, m, P, Am, AP, Pp);

    // Unrolled Cholesky of Pp + diag(pad) with a 1e-30 pivot floor.  Padded
    // dims have zero rows/columns in Pp, so pad = 1 keeps them nonsingular.
    T L[BS][BS], inv_d[BS];
#pragma unroll
    for (int j = 0; j < BS; ++j) {
      T s = Pp[j][j] + pad[j];
#pragma unroll
      for (int k = 0; k < j; ++k) s -= L[j][k] * L[j][k];
      const T d = Num<T>::sqrt_(clamp_min(s, T(1e-30)));
      L[j][j] = d;
      inv_d[j] = T(1) / d;
#pragma unroll
      for (int i = j + 1; i < BS; ++i) {
        T r = Pp[i][j];
#pragma unroll
        for (int k = 0; k < j; ++k) r -= L[i][k] * L[j][k];
        L[i][j] = r * inv_d[j];
      }
    }
    // G' = (Pp + pad)^{-1} (A P): solving column l of AP gives row l of G.
    T G[BS][BS];
#pragma unroll
    for (int l = 0; l < BS; ++l) {
      T yv[BS];
#pragma unroll
      for (int i = 0; i < BS; ++i) {
        T s = AP[i][l];
#pragma unroll
        for (int k = 0; k < i; ++k) s -= L[i][k] * yv[k];
        yv[i] = s * inv_d[i];
      }
#pragma unroll
      for (int i = BS - 1; i >= 0; --i) {
        T s = yv[i];
#pragma unroll
        for (int k = i + 1; k < BS; ++k) s -= L[k][i] * G[l][k];
        G[l][i] = s * inv_d[i];
      }
    }
    // m_s = m + G (m_next - A m);  P_s = P + G (P_next - Pp) G'
    T dm[BS], dP[BS][BS], GdP[BS][BS];
#pragma unroll
    for (int i = 0; i < BS; ++i) dm[i] = mn[i] - Am[i];
#pragma unroll
    for (int i = 0; i < BS; ++i)
#pragma unroll
      for (int k = 0; k < BS; ++k) dP[i][k] = Pn[i][k] - Pp[i][k];
#pragma unroll
    for (int i = 0; i < BS; ++i) {
      T s = T(0);
#pragma unroll
      for (int k = 0; k < BS; ++k) s += G[i][k] * dm[k];
      mn[i] = m[i] + s;
    }
#pragma unroll
    for (int i = 0; i < BS; ++i)
#pragma unroll
      for (int j = 0; j < BS; ++j) {
        T s = T(0);
#pragma unroll
        for (int k = 0; k < BS; ++k) s += G[i][k] * dP[k][j];
        GdP[i][j] = s;
      }
#pragma unroll
    for (int i = 0; i < BS; ++i)
#pragma unroll
      for (int j = 0; j < BS; ++j) {
        T s = T(0);
#pragma unroll
        for (int k = 0; k < BS; ++k) s += GdP[i][k] * G[j][k];
        Pn[i][j] = P[i][j] + s;
      }
#pragma unroll
    for (int i = 0; i < BS; ++i) sm[row * BS + i] = mn[i];
    store_mat<T, BS>(sP + row * BS * BS, Pn);
  }
}

// ---------------------------------------------------------------------------
// K3: ADF forward sweep (EP sweep 1) with in-kernel cubature moment matching
// ---------------------------------------------------------------------------
//
// One CTA of ADF_THREADS threads per signal.  Per step:
//   1. channel threads (tid < C) predict and publish fmu, HPH (and the
//      modulators' sd) to shared;
//   2. phase A: threads stride over the S sigma points, evaluate xn, link,
//      a = W link (sqrt for 'sq'), s2e, the residual and log_norm, keeping
//      xn, link and a in the thread's shared columns; a block max-reduce
//      gives the shift lmax;
//   3. phase B: per sigma point the K = 1 + 2D + 2N shifted moment terms
//      (Z, A1[D], A2[D], G1[N], G2[N]) go to shared slots; thread k then sums
//      row k over the sigma points in a fixed order (four interleaved chains,
//      no atomics: two runs give the same bits).  With S > ADF_THREADS the
//      sigma points are taken in tiles and phase B re-evaluates each tile;
//   4. channel threads form dlZ, d2lZ with the raw-scale Z floor, the damped
//      clamped site, and the measurement update.

template <typename T, int BS>
__global__ void __launch_bounds__(ADF_THREADS)
fused_adf_kernel(const T* __restrict__ y, const T* __restrict__ obs,
                 const T* __restrict__ A_, const T* __restrict__ Q_,
                 const T* __restrict__ Pinf_, const T* __restrict__ H_,
                 const T* __restrict__ W, const T* __restrict__ xi,
                 const T* __restrict__ wn, const T* __restrict__ sn2_,
                 T damp, T log_floor, int n_steps, int D, int N, int S, int link_exp_i,
                 int sq_i, T* __restrict__ ms, T* __restrict__ Ps, T* __restrict__ lZ,
                 T* __restrict__ tt_out, T* __restrict__ tn_out) {
  constexpr int NT = ADF_THREADS, PITCH = ADF_PITCH;
  constexpr int NW = NT / 32;
  const int tid = threadIdx.x;
  const int C = D + N;
  const int K = 1 + 2 * D + 2 * N;
  const bool link_exp = link_exp_i != 0, sq = sq_i != 0;
  const bool one_tile = S <= NT;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* fmu_sh = reinterpret_cast<T*>(smem_raw);
  T* hph_sh = fmu_sh + C;
  T* sd_sh = hph_sh + C;
  T* wmax = sd_sh + N;
  T* tot = wmax + NW;
  T* terms = tot + K;                     // terms[k * PITCH + tid]
  T* xn_col = terms + (size_t)K * PITCH + tid;  // xn_col[n * NT]
  T* lk_col = xn_col + (size_t)N * NT;          // lk_col[n * NT]
  T* a_col = lk_col + (size_t)N * NT;           // a_col[d * NT]
  T* W_sh = a_col - tid + (size_t)D * NT;
  T* slot = terms + tid;

  for (int i = tid; i < D * N; i += NT) W_sh[i] = W[i];
  const T sn2 = sn2_[0];

  // Channel state (threads tid < C only).
  const bool chan = tid < C;
  T A[BS][BS], Q[BS][BS], P[BS][BS], H[BS], m[BS];
  if (chan) {
    load_mat<T, BS>(A, A_ + tid * BS * BS);
    load_mat<T, BS>(Q, Q_ + tid * BS * BS);
    load_mat<T, BS>(P, Pinf_ + tid * BS * BS);
#pragma unroll
    for (int i = 0; i < BS; ++i) {
      H[i] = H_[tid * BS + i];
      m[i] = T(0);
    }
  }
  T y_next = y[0], obs_next = obs[0];

  for (int t = 0; t < n_steps; ++t) {
    const T yk = y_next;
    const bool observed = obs_next > T(0);
    if (t + 1 < n_steps) {
      y_next = y[t + 1];
      obs_next = obs[t + 1];
    }

    // ---- 1. predict and publish the observable marginals ----------------
    T mp[BS], Pp[BS][BS], PH[BS], fmu = T(0), HPH = T(0);
    if (chan) {
      T AP[BS][BS];
      predict<T, BS>(A, Q, m, P, mp, AP, Pp);
      observe<T, BS>(H, mp, Pp, fmu, PH, HPH);
      fmu_sh[tid] = fmu;
      hph_sh[tid] = HPH;
      if (tid >= D) sd_sh[tid - D] = Num<T>::sqrt_(clamp_min(HPH, T(0)));
    }
    __syncthreads();

    // ---- 2. phase A: log-normalisers and their max ----------------------
    T s2e = T(0), resid = T(0), ln = T(0);
    T lmax = -INFINITY;
    for (int s0 = 0; s0 < S; s0 += NT) {
      const int s = s0 + tid;
      if (s < S) {
        eval_sigma<T>(s, xi, fmu_sh, hph_sh, sd_sh, W_sh, xn_col, lk_col, a_col, yk, sn2, D,
                      N, link_exp, sq, s2e, resid, ln);
        lmax = ln > lmax ? ln : lmax;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const T o = __shfl_xor_sync(0xffffffffu, lmax, off);
      lmax = o > lmax ? o : lmax;
    }
    if ((tid & 31) == 0) wmax[tid >> 5] = lmax;
    __syncthreads();
    lmax = wmax[0];
#pragma unroll
    for (int w = 1; w < NW; ++w) lmax = wmax[w] > lmax ? wmax[w] : lmax;
    if (!Num<T>::finite(lmax)) lmax = T(0);

    // ---- 3. phase B: shifted moment sums in a fixed order ----------------
    for (int s0 = 0; s0 < S; s0 += NT) {
      const int s = s0 + tid;
      if (s < S) {
        if (!one_tile)
          eval_sigma<T>(s, xi, fmu_sh, hph_sh, sd_sh, W_sh, xn_col, lk_col, a_col, yk, sn2,
                        D, N, link_exp, sq, s2e, resid, ln);
        const T wns = wn[s] * Num<T>::exp_(ln - lmax);
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
      const int ns = min(S - s0, NT);  // sigma points in this tile
      for (int k = tid; k < K; k += NT) {
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
        tot[k] = (s0 == 0 ? T(0) : tot[k]) + ((acc0 + acc1) + (acc2 + acc3));
      }
      __syncthreads();
    }

    // ---- 4. derivatives, damped site, measurement update -----------------
    if (chan) {
      const T Z0 = clamp_min(tot[0], Num<T>::tiny());
      const T lZ_raw = lmax + Num<T>::log_(Z0);
      const T lZk = clamp_min(lZ_raw, log_floor);
      const T Zi = Num<T>::exp_(lZ_raw - lZk) / Z0;
      const int k1 = tid < D ? 1 + tid : 1 + 2 * D + (tid - D);
      const int k2 = tid < D ? 1 + D + tid : 1 + 2 * D + N + (tid - D);
      const T dl = Zi * tot[k1];
      const T d2 = Zi * tot[k2] - dl * dl;
      const T denom = T(1) + d2 * HPH;
      // incoming sites are zero: (1 - damp) * 0 + damp * (...)
      T tt = clamp_min(damp * (-d2 / denom), T(0));
      T tn = damp * ((dl - fmu * d2) / denom);
      if (!observed) {  // unobserved: zero sites, lZ = 0
        tt = T(0);
        tn = T(0);
      }
      const size_t row = (size_t)t * C + tid;
      tt_out[row] = tt;
      tn_out[row] = tn;
      if (tid == 0) lZ[t] = observed ? lZk : T(0);
      site_update<T, BS>(tt, tn, fmu, HPH, PH, mp, Pp, m, P);
#pragma unroll
      for (int i = 0; i < BS; ++i) ms[row * BS + i] = m[i];
      store_mat<T, BS>(Ps + row * BS * BS, P);
    }
  }
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

template <typename T, int BS>
int launch_fwd(const void* ttau, const void* tnu, const void* A, const void* Q,
               const void* Pinf, const void* H, void* ms, void* Ps, int n_steps, int C,
               cudaStream_t st) {
  const int threads = 32, blocks = (C + threads - 1) / threads;
  fused_fwd_kernel<T, BS><<<blocks, threads, 0, st>>>(
      (const T*)ttau, (const T*)tnu, (const T*)A, (const T*)Q, (const T*)Pinf,
      (const T*)H, (T*)ms, (T*)Ps, n_steps, C);
  return (int)cudaGetLastError();
}

template <typename T, int BS>
int launch_bwd(const void* ms, const void* Ps, const void* A, const void* Q,
               const void* pad, void* sm, void* sP, int n_steps, int C, cudaStream_t st) {
  const int threads = 32, blocks = (C + threads - 1) / threads;
  fused_bwd_kernel<T, BS><<<blocks, threads, 0, st>>>(
      (const T*)ms, (const T*)Ps, (const T*)A, (const T*)Q, (const T*)pad, (T*)sm,
      (T*)sP, n_steps, C);
  return (int)cudaGetLastError();
}

template <typename T, int BS>
int launch_adf(const void* y, const void* obs, const void* A, const void* Q,
               const void* Pinf, const void* H, const void* W, const void* xi,
               const void* wn, const void* sn2, double damp, double log_floor, int n_steps,
               int D, int N, int S, int link_exp, int sq, void* ms, void* Ps, void* lZ,
               void* tt, void* tn, cudaStream_t st) {
  const size_t bytes = adf_smem_elems(D + N, D, N) * sizeof(T);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_adf_kernel<T, BS>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  fused_adf_kernel<T, BS><<<1, ADF_THREADS, bytes, st>>>(
      (const T*)y, (const T*)obs, (const T*)A, (const T*)Q, (const T*)Pinf, (const T*)H,
      (const T*)W, (const T*)xi, (const T*)wn, (const T*)sn2, (T)damp, (T)log_floor,
      n_steps, D, N, S, link_exp, sq, (T*)ms, (T*)Ps, (T*)lZ, (T*)tt, (T*)tn);
  return (int)cudaGetLastError();
}

}  // namespace


extern "C" {

long long nsgp_adf_smem_bytes(int is_f64, int D, int N) {
  return (long long)(adf_smem_elems(D + N, D, N) * (is_f64 ? sizeof(double) : sizeof(float)));
}

int nsgp_fused_fwd(int is_f64, int bs, const void* ttau, const void* tnu, const void* A,
                   const void* Q, const void* Pinf, const void* H, void* ms, void* Ps,
                   int n_steps, int C, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  NSGP_DISPATCH(launch_fwd, ttau, tnu, A, Q, Pinf, H, ms, Ps, n_steps, C, st)
}

int nsgp_fused_bwd(int is_f64, int bs, const void* ms, const void* Ps, const void* A,
                   const void* Q, const void* pad, void* sm, void* sP, int n_steps, int C,
                   void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  NSGP_DISPATCH(launch_bwd, ms, Ps, A, Q, pad, sm, sP, n_steps, C, st)
}

int nsgp_fused_adf(int is_f64, int bs, const void* y, const void* obs, const void* A,
                   const void* Q, const void* Pinf, const void* H, const void* W,
                   const void* xi, const void* wn, const void* sn2, double damp,
                   double log_floor, int n_steps, int D, int N, int S, int link_exp,
                   int sq, void* ms, void* Ps, void* lZ, void* tt, void* tn, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  NSGP_DISPATCH(launch_adf, y, obs, A, Q, Pinf, H, W, xi, wn, sn2, damp, log_floor, n_steps,
                D, N, S, link_exp, sq, ms, Ps, lZ, tt, tn, st)
}

}  // extern "C"
