// Fused Kalman filter and RTS smoother kernels for Hopper (sm_90a).
//
// Hand-written CUDA counterparts of two Pallas kernels on the GT-NMF
// Power-EP path (nsgp_tpu/ops/pallas_kalman.py):
//
//   fused_fwd_kernel  replaces pallas_kalman.py:_fwd_kernel  (K1)
//   fused_bwd_kernel  replaces pallas_kalman.py:_bwd_kernel  (K2)
//
// (K3 and K4, the ADF sweeps, are in fused_adf.cuh and fused_adf_mb.cuh.)
//
// Each is a sequential recursion over T with a tiny per-channel state
// (bs + bs*bs <= 72 values, bs <= 8): one thread carries one channel's m and P
// in registers for the whole time loop, and the loop over T runs inside the
// kernel, so a pass is one launch.  What bounds them on this card is the
// latency of the dependent per-step chain (predict -> marginals -> update),
// not bytes or FLOPs: a pass uses ceil(C / 32) SMs of 132.  Loads of the next
// step's inputs are issued one step ahead so their latency overlaps the
// current step's arithmetic.
//
// Layouts (C-major, what inference/ep.py consumes; no padding of T):
//   sites        (T, C)                 A, Q, Pinf (C, bs, bs)   H, pad (C, bs)
//   ms           (T, C, bs)             Ps         (T, C, bs, bs)
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

}  // namespace


extern "C" {

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

}  // extern "C"
