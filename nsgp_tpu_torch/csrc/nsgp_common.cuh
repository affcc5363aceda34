// Shared pieces of the fused Kalman / ADF kernels (sm_90a): number traits,
// the per-channel block algebra and the link functions.  Included by
// fused_kalman.cu (K1, K2) and, through adf_step.cuh, by fused_adf.cuh (K3)
// and fused_adf_mb.cuh (K4); everything lives in an anonymous namespace, so
// each translation unit gets its own copy and the objects link into one
// library.

#pragma once

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

namespace {

template <typename T> struct Num;
template <> struct Num<float> {
  static __device__ __forceinline__ float sqrt_(float x) { return sqrtf(x); }
  // sqrt of a positive normal number without sqrtf's special-case branch:
  // rsqrt and one Newton step on the residual, within an ulp of sqrtf.
  static __device__ __forceinline__ float sqrt_pos(float x) {
    const float r = rsqrtf(x), a = x * r;
    return fmaf(fmaf(-a, a, x), 0.5f * r, a);
  }
  static __device__ __forceinline__ float exp_(float x) { return expf(x); }
  static __device__ __forceinline__ float log_(float x) { return logf(x); }
  static __device__ __forceinline__ float log1p_(float x) { return log1pf(x); }
  static __device__ __forceinline__ float abs_(float x) { return fabsf(x); }
  static __device__ __forceinline__ float tiny() { return FLT_MIN; }
  static __device__ __forceinline__ bool finite(float x) { return fabsf(x) <= FLT_MAX; }
};
template <> struct Num<double> {
  static __device__ __forceinline__ double sqrt_(double x) { return sqrt(x); }
  static __device__ __forceinline__ double sqrt_pos(double x) { return sqrt(x); }
  static __device__ __forceinline__ double exp_(double x) { return exp(x); }
  static __device__ __forceinline__ double log_(double x) { return log(x); }
  static __device__ __forceinline__ double log1p_(double x) { return log1p(x); }
  static __device__ __forceinline__ double abs_(double x) { return fabs(x); }
  static __device__ __forceinline__ double tiny() { return DBL_MIN; }
  static __device__ __forceinline__ bool finite(double x) { return fabs(x) <= DBL_MAX; }
};

// max(x, lo) that propagates NaN like jnp.maximum / torch.clamp_min
// (fmax would silently drop it).
template <typename T>
__device__ __forceinline__ T clamp_min(T x, T lo) { return x < lo ? lo : x; }

// ---------------------------------------------------------------------------
// Per-channel block algebra, fully unrolled over the compile-time block size
// ---------------------------------------------------------------------------

template <typename T, int BS>
__device__ __forceinline__ void load_mat(T (&M)[BS][BS], const T* __restrict__ src) {
#pragma unroll
  for (int i = 0; i < BS; ++i)
#pragma unroll
    for (int k = 0; k < BS; ++k) M[i][k] = src[i * BS + k];
}

template <typename T, int BS>
__device__ __forceinline__ void store_mat(T* __restrict__ dst, const T (&M)[BS][BS]) {
#pragma unroll
  for (int i = 0; i < BS; ++i)
#pragma unroll
    for (int k = 0; k < BS; ++k) dst[i * BS + k] = M[i][k];
}

// mp = A m;  AP = A P;  Pp = AP A' + Q
template <typename T, int BS>
__device__ __forceinline__ void predict(const T (&A)[BS][BS], const T (&Q)[BS][BS],
                                        const T (&m)[BS], const T (&P)[BS][BS],
                                        T (&mp)[BS], T (&AP)[BS][BS], T (&Pp)[BS][BS]) {
#pragma unroll
  for (int i = 0; i < BS; ++i) {
    T s = T(0);
#pragma unroll
    for (int k = 0; k < BS; ++k) s += A[i][k] * m[k];
    mp[i] = s;
  }
#pragma unroll
  for (int i = 0; i < BS; ++i)
#pragma unroll
    for (int j = 0; j < BS; ++j) {
      T s = T(0);
#pragma unroll
      for (int k = 0; k < BS; ++k) s += A[i][k] * P[k][j];
      AP[i][j] = s;
    }
#pragma unroll
  for (int i = 0; i < BS; ++i)
#pragma unroll
    for (int j = 0; j < BS; ++j) {
      T s = T(0);
#pragma unroll
      for (int k = 0; k < BS; ++k) s += AP[i][k] * A[j][k];
      Pp[i][j] = s + Q[i][j];
    }
}

// fmu = H mp;  PH = Pp H;  HPH = H' PH
template <typename T, int BS>
__device__ __forceinline__ void observe(const T (&H)[BS], const T (&mp)[BS],
                                        const T (&Pp)[BS][BS], T& fmu, T (&PH)[BS],
                                        T& HPH) {
  fmu = T(0);
#pragma unroll
  for (int i = 0; i < BS; ++i) fmu += H[i] * mp[i];
#pragma unroll
  for (int i = 0; i < BS; ++i) {
    T s = T(0);
#pragma unroll
    for (int k = 0; k < BS; ++k) s += Pp[i][k] * H[k];
    PH[i] = s;
  }
  HPH = T(0);
#pragma unroll
  for (int i = 0; i < BS; ++i) HPH += H[i] * PH[i];
}

// Branch-free z-form site update (zero sites are an exact no-op).
template <typename T, int BS>
__device__ __forceinline__ void site_update(T tt, T tn, T fmu, T HPH, const T (&PH)[BS],
                                            const T (&mp)[BS], const T (&Pp)[BS][BS],
                                            T (&m)[BS], T (&P)[BS][BS]) {
  const T z = tt * HPH + T(1);
  const T v = (tt * fmu - tn) / z;
  const T w = tt / z;
#pragma unroll
  for (int i = 0; i < BS; ++i) m[i] = mp[i] - PH[i] * v;
#pragma unroll
  for (int i = 0; i < BS; ++i)
#pragma unroll
    for (int k = 0; k < BS; ++k) P[i][k] = Pp[i][k] - w * PH[i] * PH[k];
}

// ---------------------------------------------------------------------------
// The link function of the ADF kernels (K3, K4; the step is in adf_step.cuh)
// ---------------------------------------------------------------------------

constexpr double LOG2PI = 1.8378770664093453;

template <typename T>
__device__ __forceinline__ T link_fn(T x, bool link_exp) {
  if (link_exp) return Num<T>::exp_(x);
  // softplus as logaddexp(x, 0): exact for all x
  return (x > T(0) ? x : T(0)) + Num<T>::log1p_(Num<T>::exp_(-Num<T>::abs_(x)));
}

}  // namespace

// Dispatch on bs (1..8) for one dtype T.
#define NSGP_DISPATCH_BS(FN, T, ...)                 \
  switch (bs) {                                      \
    case 1: return FN<T, 1>(__VA_ARGS__);            \
    case 2: return FN<T, 2>(__VA_ARGS__);            \
    case 3: return FN<T, 3>(__VA_ARGS__);            \
    case 4: return FN<T, 4>(__VA_ARGS__);            \
    case 5: return FN<T, 5>(__VA_ARGS__);            \
    case 6: return FN<T, 6>(__VA_ARGS__);            \
    case 7: return FN<T, 7>(__VA_ARGS__);            \
    case 8: return FN<T, 8>(__VA_ARGS__);            \
    default: return -1;                              \
  }

// Dispatch on (dtype: 0 = float32, 1 = float64) x (bs: 1..8).
#define NSGP_DISPATCH(FN, ...)                                   \
  switch (bs) {                                                  \
    case 1: return is_f64 ? FN<double, 1>(__VA_ARGS__) : FN<float, 1>(__VA_ARGS__); \
    case 2: return is_f64 ? FN<double, 2>(__VA_ARGS__) : FN<float, 2>(__VA_ARGS__); \
    case 3: return is_f64 ? FN<double, 3>(__VA_ARGS__) : FN<float, 3>(__VA_ARGS__); \
    case 4: return is_f64 ? FN<double, 4>(__VA_ARGS__) : FN<float, 4>(__VA_ARGS__); \
    case 5: return is_f64 ? FN<double, 5>(__VA_ARGS__) : FN<float, 5>(__VA_ARGS__); \
    case 6: return is_f64 ? FN<double, 6>(__VA_ARGS__) : FN<float, 6>(__VA_ARGS__); \
    case 7: return is_f64 ? FN<double, 7>(__VA_ARGS__) : FN<float, 7>(__VA_ARGS__); \
    case 8: return is_f64 ? FN<double, 8>(__VA_ARGS__) : FN<float, 8>(__VA_ARGS__); \
    default: return -1;                                          \
  }
