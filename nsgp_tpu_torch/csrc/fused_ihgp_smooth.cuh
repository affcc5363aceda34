// IHGP's steady RTS smoother for Hopper (sm_90a): the sequential form's
// backward pass over the filtered means in one launch.
//
//   fused_ihgp_smooth_kernel  replaces nsgp_tpu/inference/ihgp.py:658, the
//                             jax.lax.scan of _steady_smoother   (K6)
//
// What it computes (ops/fused_ihgp.py:fused_ihgp_smooth_plain): with
// G_k = Gn[c, idx_k], the last row ms_{T-1} = mf_{T-1} and, walking back,
//   ms_k = G_k ms_{k+1} + (mf_k - G_k A mf_k).
// Means only: the variances are a table lookup (hPSh) outside.
//
// Bound: a T-long recursion of a bs x bs matrix-vector product a channel,
// latency and not bytes (T * C * (2 bs + 1) values at most).  The design:
// * the channels are independent, so no barrier: BS lanes of a warp own a
//   channel (32 / BS channels a warp), lane i row i of the channel's block;
//   a product's vector is handed round by shuffles within the BS lanes;
// * idx is known in advance, so the gains are fetched ahead: the walk goes
//   in blocks of U steps whose G rows and filtered means are loaded
//   together (one load latency a block, not a step), the indices of the
//   next block while this one runs, and the constant parts
//   c_k = mf_k - G_k A mf_k of the block before its dependent recursion.
//
// Layouts, exactly T steps: ms, sm (T, C, bs); idx (T, C) int32 in [0, G);
// A (C, bs, bs); Gn (C, G, bs, bs).
//
// Build flags as fused_kalman.cuh (never --use_fast_math).  Compiled once per
// dtype, by fused_ihgp_smooth_f32.cu and fused_ihgp_smooth_f64.cu.

#pragma once

#include "nsgp_common.cuh"

namespace {

constexpr int SMOOTH_THREADS = 128;

template <typename T, int BS>
__global__ void __launch_bounds__(SMOOTH_THREADS)
fused_ihgp_smooth_kernel(const T* __restrict__ ms, const int* __restrict__ idx,
                         const T* __restrict__ A, const T* __restrict__ Gn, T* __restrict__ sm,
                         int n_steps, int C, int G) {
  constexpr int CPW = 32 / BS;        // channels a warp
  constexpr int U = BS <= 4 ? 8 : 4;  // steps a block of loads
  const int lane = threadIdx.x & 31;
  const int warp = (blockIdx.x * SMOOTH_THREADS + (int)threadIdx.x) >> 5;
  const int slot = lane / BS;
  const bool in_warp = slot < CPW;           // lanes past 32 / BS * BS idle
  const int i = in_warp ? lane - slot * BS : 0;  // this lane's row
  const int base = in_warp ? slot * BS : lane;   // the channel's first lane
  const bool live = in_warp && warp * CPW + slot < C;
  const int c = live ? warp * CPW + slot : 0;  // idle lanes load channel 0, store nothing

  T Ai[BS];
#pragma unroll
  for (int j = 0; j < BS; ++j) Ai[j] = A[((size_t)c * BS + i) * BS + j];
  const T* Gc = Gn + (size_t)c * G * BS * BS + (size_t)i * BS;  // row i of grid point 0
  const size_t step = (size_t)C * BS;                            // a time row of ms, sm
  const T* msc = ms + (size_t)c * BS + i;
  T* smc = sm + (size_t)c * BS + i;
  const int* idc = idx + c;

  T mnext = msc[(size_t)(n_steps - 1) * step];
  if (live) smc[(size_t)(n_steps - 1) * step] = mnext;

  int idn[U];  // the indices of the next block
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int k = n_steps - 2 - u;
    idn[u] = k >= 0 ? idc[(size_t)k * C] : 0;
  }
  for (int k0 = n_steps - 2; k0 >= 0; k0 -= U) {
    int id[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      id[u] = idn[u];
      const int k = k0 - U - u;
      idn[u] = k >= 0 ? idc[(size_t)k * C] : 0;
    }
    T g[U][BS], mf[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const bool on = k0 - u >= 0;
      const T* gr = Gc + (size_t)id[u] * BS * BS;
#pragma unroll
      for (int j = 0; j < BS; ++j) g[u][j] = on ? gr[j] : T(0);
      mf[u] = on ? msc[(size_t)(k0 - u) * step] : T(0);
    }
    // c_k = mf_k - G_k (A mf_k), off the recursion's path
    T cu[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      T am = T(0);
#pragma unroll
      for (int j = 0; j < BS; ++j) am += Ai[j] * __shfl_sync(0xffffffffu, mf[u], base + j);
      T gam = T(0);
#pragma unroll
      for (int j = 0; j < BS; ++j) gam += g[u][j] * __shfl_sync(0xffffffffu, am, base + j);
      cu[u] = mf[u] - gam;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k = k0 - u;
      if (k >= 0) {  // uniform over the warp
        T s = T(0);
#pragma unroll
        for (int j = 0; j < BS; ++j) s += g[u][j] * __shfl_sync(0xffffffffu, mnext, base + j);
        mnext = s + cu[u];
        if (live) smc[(size_t)k * step] = mnext;
      }
    }
  }
}

template <typename T, int BS>
int launch_ihgp_smooth(const void* ms, const void* idx, const void* A, const void* Gn, void* sm,
                       int n_steps, int C, int G, cudaStream_t st) {
  if (n_steps < 1 || C < 1 || G < 1) return -2;
  constexpr int CPW = 32 / BS;
  const int warps = (C + CPW - 1) / CPW;
  const int blocks = (warps * 32 + SMOOTH_THREADS - 1) / SMOOTH_THREADS;
  fused_ihgp_smooth_kernel<T, BS><<<blocks, SMOOTH_THREADS, 0, st>>>(
      (const T*)ms, (const int*)idx, (const T*)A, (const T*)Gn, (T*)sm, n_steps, C, G);
  return (int)cudaGetLastError();
}

}  // namespace

// The C entry point of one dtype: nsgp_fused_ihgp_smooth_<SUFFIX>.
#define NSGP_DEFINE_FUSED_IHGP_SMOOTH(SUFFIX, T)                                              \
  extern "C" int nsgp_fused_ihgp_smooth_##SUFFIX(int bs, const void* ms, const void* idx,     \
                                                 const void* A, const void* Gn, void* sm,     \
                                                 int n_steps, int C, int G, void* stream) {   \
    cudaStream_t st = (cudaStream_t)stream;                                                   \
    NSGP_DISPATCH_BS(launch_ihgp_smooth, T, ms, idx, A, Gn, sm, n_steps, C, G, st)            \
  }
