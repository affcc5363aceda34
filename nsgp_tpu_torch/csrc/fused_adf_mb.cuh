// Batched ADF forward sweep for Hopper (sm_90a): EP sweep 1 over BF signals.
//
//   fused_adf_mb_kernel  replaces pallas_kalman.py:_adf_kernel_mb  (K4)
//
// What it computes, per (file, step), is what the single-signal kernel (K3,
// fused_adf.cuh) computes; both run adf_sweep (adf_step.cuh).  What the
// batched kernel adds:
//
// * A file is a cluster of R CTAs, R = min(8, ceil(S / 512)) (one CTA at the
//   corpus width S = 77, eight at mixture width S = 3973).  The grid is
//   (BF * R,), file b = blockIdx.x / R, and every per-file constant is
//   indexed by b: A, Q, Pinf (BF, C, bs, bs), H (BF, C, bs), W (BF, D, N),
//   sn2 (BF,).  Files share nothing but the unit sigma points, so any BF is
//   accepted.  (The TPU kernel packs the files onto one core's lanes and
//   needs 0/1 selector matmuls to reduce per file; none of that exists here.)
// * Each sigma point is evaluated once, whatever s_chunk the wrapper was
//   given: every lane keeps its totals under its own running shift and the
//   partials are merged once per step (adf_step.cuh), which is the streamed
//   form with a chunk of one point a lane.  Every output is a ratio in which
//   the shift cancels, so the chunking changes rounding only.
// * A step whose sample is unobserved skips the cubature altogether (the
//   branch is uniform over the cluster): its sites are zero, lZ = 0 and the
//   update is a no-op.
//
// Bound: a latency-bound recursion, one cluster per file; see adf_step.cuh
// for what a step costs and what the design does about it.
//
// Layouts at the kernel boundary, exactly T steps:
//   y, obs, lZ (T, BF)        tt, tn (T, BF, C)
//   ms (T, BF, C, bs)         Ps (T, BF, C, bs, bs)
// Viewed as (T, BF*C, ...) they are what K1 and K2 take.
//
// Build flags as fused_kalman.cuh (never --use_fast_math).  The kernel is
// compiled once per dtype, by fused_adf_mb_f32.cu and fused_adf_mb_f64.cu, so
// the two halves of its instantiations build side by side.

#pragma once

#include "adf_step.cuh"

namespace {

template <typename T, int BS>
__global__ void __launch_bounds__(ADF_THREADS, 1)
fused_adf_mb_kernel(const T* __restrict__ y, const T* __restrict__ obs,
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
int launch_adf_mb(const void* y, const void* obs, const void* A, const void* Q,
                  const void* Pinf, const void* H, const void* W, const void* xi,
                  const void* wn, const void* sn2, double damp, double log_floor,
                  int n_steps, int BF, int D, int N, int S, int link_exp, int sq, void* ms,
                  void* Ps, void* lZ, void* tt, void* tn, void* cyc, cudaStream_t st) {
  return launch_adf_sweep<T>(fused_adf_mb_kernel<T, BS>, y, obs, A, Q, Pinf, H, W, xi, wn,
                             sn2, damp, log_floor, n_steps, BF, D, N, S, link_exp, sq, ms, Ps,
                             lZ, tt, tn, cyc, st);
}

}  // namespace

// The C entry point of one dtype: nsgp_fused_adf_mb_<SUFFIX>.  `cycles`:
// null, or nsgp_adf_probe_phases() + 1 int64 that a library built with
// -DNSGP_CLOCK_PROBE fills with clock64() sums per phase and the count of
// observed steps (tools/probe_adf_cycles.py).
#define NSGP_DEFINE_FUSED_ADF_MB(SUFFIX, T)                                                   \
  extern "C" int nsgp_fused_adf_mb_##SUFFIX(                                                  \
      int bs, const void* y, const void* obs, const void* A, const void* Q, const void* Pinf, \
      const void* H, const void* W, const void* xi, const void* wn, const void* sn2,          \
      double damp, double log_floor, int n_steps, int BF, int D, int N, int S, int link_exp,  \
      int sq, void* ms, void* Ps, void* lZ, void* tt, void* tn, void* cycles, void* stream) { \
    cudaStream_t st = (cudaStream_t)stream;                                                   \
    NSGP_DISPATCH_BS(launch_adf_mb, T, y, obs, A, Q, Pinf, H, W, xi, wn, sn2, damp,           \
                     log_floor, n_steps, BF, D, N, S, link_exp, sq, ms, Ps, lZ, tt, tn,       \
                     cycles, st)                                                              \
  }
