// Shared pieces of the fused Kalman / ADF kernels (sm_90a): number traits,
// the per-channel block algebra, the link functions and the evaluation of
// one sigma point.  Included by fused_kalman.cu (K1-K3) and fused_adf_mb.cu
// (K4); everything lives in an anonymous namespace, so each translation
// unit gets its own copy and the objects link into one library.

#pragma once

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

namespace {

template <typename T> struct Num;
template <> struct Num<float> {
  static __device__ __forceinline__ float sqrt_(float x) { return sqrtf(x); }
  static __device__ __forceinline__ float exp_(float x) { return expf(x); }
  static __device__ __forceinline__ float log_(float x) { return logf(x); }
  static __device__ __forceinline__ float log1p_(float x) { return log1pf(x); }
  static __device__ __forceinline__ float abs_(float x) { return fabsf(x); }
  static __device__ __forceinline__ float tiny() { return FLT_MIN; }
  static __device__ __forceinline__ bool finite(float x) { return fabsf(x) <= FLT_MAX; }
};
template <> struct Num<double> {
  static __device__ __forceinline__ double sqrt_(double x) { return sqrt(x); }
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
// ADF pieces shared by the single-signal kernel (K3) and the batched one (K4)
// ---------------------------------------------------------------------------

constexpr int ADF_THREADS = 128;
constexpr int ADF_PITCH = ADF_THREADS + 1;  // row pitch of the moment terms:
// odd, so threads summing different rows hit different banks
constexpr double LOG2PI = 1.8378770664093453;

// Shared layout, in elements of T.
__host__ __device__ inline size_t adf_smem_elems(int C, int D, int N) {
  const int K = 1 + 2 * D + 2 * N;
  return (size_t)2 * C                  // fmu, HPH
         + N                            // modulator sd = sqrt(max(HPH, 0))
         + ADF_THREADS / 32             // per-warp max
         + K                            // tile totals
         + (size_t)K * ADF_PITCH        // per-thread moment terms
         + (size_t)(2 * N + D) * ADF_THREADS  // per-thread xn, link, a columns
         + (size_t)D * N;               // W
}

template <typename T>
__device__ __forceinline__ T link_fn(T x, bool link_exp) {
  if (link_exp) return Num<T>::exp_(x);
  // softplus as logaddexp(x, 0): exact for all x
  return (x > T(0) ? x : T(0)) + Num<T>::log1p_(Num<T>::exp_(-Num<T>::abs_(x)));
}

// Evaluate sigma point s: its modulator inputs xn, link values and
// amplitudes a go to this thread's columns of shared memory (col[i * NT]);
// returns s2e, resid, log_norm.
template <typename T>
__device__ __forceinline__ void eval_sigma(int s, const T* __restrict__ xi,
                                           const T* __restrict__ fmu_sh,
                                           const T* __restrict__ hph_sh,
                                           const T* __restrict__ sd_sh,
                                           const T* __restrict__ W_sh,
                                           T* __restrict__ xn_col, T* __restrict__ lk_col,
                                           T* __restrict__ a_col, T yk, T sn2, int D, int N,
                                           bool link_exp, bool sq, T& s2e, T& resid, T& ln) {
  constexpr int NT = ADF_THREADS;
  for (int n = 0; n < N; ++n) {
    const T xn = fmu_sh[D + n] + sd_sh[n] * xi[(size_t)s * N + n];
    xn_col[n * NT] = xn;
    lk_col[n * NT] = link_fn(xn, link_exp);
  }
  T se = T(0), mean = T(0);
  for (int d = 0; d < D; ++d) {
    T ad = T(0);
    for (int n = 0; n < N; ++n) ad += lk_col[n * NT] * W_sh[d * N + n];
    if (sq) ad = Num<T>::sqrt_(clamp_min(ad, T(1e-12)));
    a_col[d * NT] = ad;
    se += ad * ad * hph_sh[d];
    mean += ad * fmu_sh[d];
  }
  s2e = sn2 + se;
  resid = yk - mean;
  ln = T(-0.5) * (resid * resid / s2e + Num<T>::log_(s2e) + T(LOG2PI));
}

}  // namespace

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
