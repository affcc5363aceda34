// ADF forward sweep of one signal for Hopper (sm_90a): EP sweep 1.
//
//   fused_adf_kernel  replaces pallas_kalman.py:_adf_kernel  (K3)
//
// Per step: predict, cubature moment match at the predicted marginal with
// the raw-scale Z floor, damped clamped site from zero incoming sites,
// measurement update.  The step is adf_sweep (adf_step.cuh), the code the
// batched kernel (K4, fused_adf_mb.cuh) runs per file: K3 is its BF = 1
// instantiation.  What bounds the kernel and what the design does about it
// is written at the top of adf_step.cuh: it is the latency of one step of a
// T-long recursion on one SM (one cluster when S > 512), so the step keeps
// its sigma points in register tiles, its totals in registers under
// per-lane shifts, and crosses two block barriers.
//
// Layouts, exactly T steps:
//   y, obs, lZ (T,)   tt, tn (T, C)   ms (T, C, bs)   Ps (T, C, bs, bs)
//   A, Q, Pinf (C, bs, bs)   H (C, bs)   W (D, N)   xi (S, N)   wn (S,)
//
// Build flags as fused_kalman.cuh (never --use_fast_math).  The kernel is
// compiled once per dtype, by fused_adf_f32.cu and fused_adf_f64.cu, so the
// two halves of its instantiations build side by side.

#pragma once

#include "adf_step.cuh"

namespace {

template <typename T, int BS>
__global__ void __launch_bounds__(ADF_THREADS, 1)
fused_adf_kernel(const T* __restrict__ y, const T* __restrict__ obs,
                 const T* __restrict__ A, const T* __restrict__ Q,
                 const T* __restrict__ Pinf, const T* __restrict__ H,
                 const T* __restrict__ W, const T* __restrict__ xi,
                 const T* __restrict__ wn, const T* __restrict__ sn2, T damp, T log_floor,
                 int n_steps, int BF, int D, int N, int S, int R, int link_exp, int sq,
                 T* __restrict__ ms, T* __restrict__ Ps, T* __restrict__ lZ,
                 T* __restrict__ tt, T* __restrict__ tn, long long* __restrict__ cyc) {
  adf_sweep<T, BS>(y, obs, A, Q, Pinf, H, W, xi, wn, sn2, damp, log_floor, n_steps, BF, D, N,
                   S, R, link_exp, sq, ms, Ps, lZ, tt, tn, cyc);
}

template <typename T, int BS>
int launch_adf(const void* y, const void* obs, const void* A, const void* Q,
               const void* Pinf, const void* H, const void* W, const void* xi,
               const void* wn, const void* sn2, double damp, double log_floor, int n_steps,
               int D, int N, int S, int link_exp, int sq, void* ms, void* Ps, void* lZ,
               void* tt, void* tn, cudaStream_t st) {
  return launch_adf_sweep<T>(fused_adf_kernel<T, BS>, y, obs, A, Q, Pinf, H, W, xi, wn, sn2,
                             damp, log_floor, n_steps, /*BF=*/1, D, N, S, link_exp, sq, ms, Ps,
                             lZ, tt, tn, nullptr, st);
}

}  // namespace

// The C entry point of one dtype: nsgp_fused_adf_<SUFFIX>.
#define NSGP_DEFINE_FUSED_ADF(SUFFIX, T)                                                      \
  extern "C" int nsgp_fused_adf_##SUFFIX(                                                     \
      int bs, const void* y, const void* obs, const void* A, const void* Q, const void* Pinf, \
      const void* H, const void* W, const void* xi, const void* wn, const void* sn2,          \
      double damp, double log_floor, int n_steps, int D, int N, int S, int link_exp, int sq,  \
      void* ms, void* Ps, void* lZ, void* tt, void* tn, void* stream) {                       \
    cudaStream_t st = (cudaStream_t)stream;                                                   \
    NSGP_DISPATCH_BS(launch_adf, T, y, obs, A, Q, Pinf, H, W, xi, wn, sn2, damp, log_floor,   \
                     n_steps, D, N, S, link_exp, sq, ms, Ps, lZ, tt, tn, st)                  \
  }
