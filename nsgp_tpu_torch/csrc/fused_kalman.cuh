// Fused Kalman filter and RTS smoother for Hopper (sm_90a), as blocked
// parallel-in-time passes.
//
// Hand-written CUDA counterparts of two Pallas kernels on the GT-NMF
// Power-EP path (nsgp_tpu/ops/pallas_kalman.py):
//
//   fused_fwd (fwd_* kernels below)  replaces pallas_kalman.py:_fwd_kernel  (K1)
//   fused_bwd (bwd_* kernels below)  replaces pallas_kalman.py:_bwd_kernel  (K2)
//
// (K3 and K4, the ADF sweeps, are in fused_adf.cuh and fused_adf_mb.cuh.)
//
// What bounds them.  Both are recursions over T with a tiny per-channel state
// (bs + bs*bs <= 72 values, bs <= 8).  By bytes they are worth microseconds
// (every input read once, every output written once), but a step waits for
// the step before it: one thread carrying one channel through all T steps is
// a chain of T dependent steps of about 1300 cycles on as many lanes as
// there are channels, 19 lanes of one warp on one of 132 SMs for one signal.
// The latency of that chain, not bytes or FLOPs, is the bound.
//
// What the design does about it.  With the sites fixed (K1) or the filtered
// trajectory stored (K2) a step is an affine map of the carried state, and
// affine maps compose: the blocked two-level scan of nsgp_tpu/ops/bscan.py.
// T is cut into nc chunks of L steps (L from ops/fused_kalman.py:
// chunk_length) and a pass becomes three launches on one stream:
//
//   pass 1  one thread per (chunk, channel), channels fastest: walk the
//           chunk's L steps and compose them into the chunk's total, held in
//           registers, stored once.  All chunks at once.
//   pass 2  one thread per channel: carry the STATE (not an element) through
//           the nc totals and store the state that enters every chunk.
//   pass 3  one thread per (chunk, channel): the sequential step from the
//           chunk's carry, writing the outputs.
//
// The dependent chain is 2 L + nc short steps instead of T, and nc * C
// threads fill the card.  One chunk (T <= L) is pass 3 alone: the sequential
// pass.  No atomics and a fixed chunk order: the same (T, C, dtype) gives the
// same bits from run to run.
//
// K1's total is the five-tuple (At, b, Cm, eta, J) of nsgp_tpu/ops/pscan.py:
// x_end | x_0, sites ~ N(At x_0 + b, Cm), and (eta, J) is what the chunk's
// sites say of x_0 in information form.  Folding ONE step into it is the
// filter step itself run on (b, Cm) from (0, 0), with At <- (I - K H) A At
// carried along and one rank-one term h h' tt/z, h = H A At, added to J (and
// -h v to eta): the combine's (I + C J)^-1 collapses to the scalar 1 / z
// (Sherman-Morrison), so no bs x bs solve is inside the T loop, nothing is
// formed by cancellation (J and eta are sums; Cm is a filter covariance) and a
// zero site reduces exactly to prediction.  Pass 2 applies a total to the
// state, D = (I + P J)^-1, m <- At D (m + P eta) + b, P <- At sym(D P) At' +
// Cm: the one general solve, nc times a channel, by elimination with partial
// pivoting (padded dims have zero rows in P, so I + P J is the identity
// there).  The filter predicts at every step, the first included, from
// (0, Pinf): with the stationary Q = Pinf - A Pinf A' that is an exact no-op,
// so chunk 0 needs no special first element (bscan.py has one).
//
// K2's step, mn <- m + G (mn - A m), Pn <- P + G (Pn - Pp) G', is affine in the
// carry (mn, Pn); the gain G (predict, Cholesky of Pp + pad with a 1e-30
// pivot floor, 2 bs triangular solves) needs only the stored m, P.  Pass 1
// runs that very step from a ZERO carry, which yields the map's constant part
// (g, L), and multiplies the gains up for its linear part, E <- G E; pass 2
// is mn <- E mn + g, Pn <- E Pn E' + L from the last step's prediction down.
// The gains are recomputed in pass 3 rather than stored.
//
// In float32 the totals stay float32: on a trained model with a 1e5-sample
// lengthscale (Q about 1e-10 of Pinf) the blocked passes stay within 1e-5 of
// the sequential ones relative to the outputs' max, at L = 32 .. 512.
//
// Layouts (C-major, what inference/ep.py consumes; no padding of T):
//   sites        (T, C)                 A, Q, Pinf (C, bs, bs)   H, pad (C, bs)
//   ms           (T, C, bs)             Ps         (T, C, bs, bs)
//   totals       (chunk, value, C)      carries    (chunk, value, C)
// so that a warp's loads of a site row and its accesses to the scratch are
// contiguous over the channels.  Rows of m and P move as 16-byte vectors
// where their size allows (bs = 4: one float4 for m, four for P); the inputs
// of the next step are requested one step ahead.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC.  Never with --use_fast_math: ~4e-3 relative error
// in the residual y - mean (catastrophic cancellation once sites converge)
// diverged the EP sweeps by sweep 3 on the TPU.  Each kernel is compiled once
// per dtype (fused_fwd_f32.cu, fused_fwd_f64.cu, fused_bwd_f32.cu,
// fused_bwd_f64.cu), so the four quarters of the instantiations build side by
// side.
//
// Every entry point launches on the given stream, does not synchronise,
// allocates nothing (the wrapper hands it the scratch), and returns the first
// cudaGetLastError() that is not 0 (or -1 for an unsupported block size or a
// size below 1).

#pragma once

#include "nsgp_common.cuh"

namespace {

constexpr int KALMAN_THREADS = 32;  // a block: one warp, so few threads spread over all SMs

// ---------------------------------------------------------------------------
// Rows of m and P as 16-byte vectors
// ---------------------------------------------------------------------------

template <typename T> struct Vec16;
template <> struct Vec16<float> { using type = float4; };
template <> struct Vec16<double> { using type = double2; };

// N consecutive values at p (16-byte aligned whenever N * sizeof(T) is a
// multiple of 16: the wrapper checks the base pointers).
template <typename T, int N>
__device__ __forceinline__ void load_row(T (&x)[N], const T* __restrict__ p) {
  constexpr int W = 16 / sizeof(T);
  if constexpr (N % W == 0) {
    using V = typename Vec16<T>::type;
#pragma unroll
    for (int q = 0; q < N / W; ++q) {
      const V v = reinterpret_cast<const V*>(p)[q];
      x[q * W] = v.x;
      x[q * W + 1] = v.y;
      if constexpr (W == 4) {
        x[q * W + 2] = v.z;
        x[q * W + 3] = v.w;
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = p[i];
  }
}

template <typename T, int N>
__device__ __forceinline__ void store_row(T* __restrict__ p, const T (&x)[N]) {
  constexpr int W = 16 / sizeof(T);
  if constexpr (N % W == 0) {
    using V = typename Vec16<T>::type;
#pragma unroll
    for (int q = 0; q < N / W; ++q) {
      V v;
      v.x = x[q * W];
      v.y = x[q * W + 1];
      if constexpr (W == 4) {
        v.z = x[q * W + 2];
        v.w = x[q * W + 3];
      }
      reinterpret_cast<V*>(p)[q] = v;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) p[i] = x[i];
  }
}

// A bs x bs matrix is bs * bs consecutive values (through a flat copy, so
// that every index stays a compile-time constant and the values registers).
template <typename T, int BS>
__device__ __forceinline__ void unflatten(T (&M)[BS][BS], const T (&x)[BS * BS]) {
#pragma unroll
  for (int i = 0; i < BS; ++i)
#pragma unroll
    for (int k = 0; k < BS; ++k) M[i][k] = x[i * BS + k];
}

template <typename T, int BS>
__device__ __forceinline__ void flatten(T (&x)[BS * BS], const T (&M)[BS][BS]) {
#pragma unroll
  for (int i = 0; i < BS; ++i)
#pragma unroll
    for (int k = 0; k < BS; ++k) x[i * BS + k] = M[i][k];
}

template <typename T, int BS>
__device__ __forceinline__ void load_mat_v(T (&M)[BS][BS], const T* __restrict__ p) {
  T x[BS * BS];
  load_row<T, BS * BS>(x, p);
  unflatten<T, BS>(M, x);
}

template <typename T, int BS>
__device__ __forceinline__ void store_mat_v(T* __restrict__ p, const T (&M)[BS][BS]) {
  T x[BS * BS];
  flatten<T, BS>(x, M);
  store_row<T, BS * BS>(p, x);
}

// The scratch: value j of (chunk k, channel c) at ((k * NV + j) * C + c).
template <typename T, int N>
__device__ __forceinline__ void load_soa(T (&x)[N], const T* __restrict__ p, int C) {
#pragma unroll
  for (int j = 0; j < N; ++j) x[j] = p[(size_t)j * C];
}

template <typename T, int N>
__device__ __forceinline__ void store_soa(T* __restrict__ p, int C, const T (&x)[N]) {
#pragma unroll
  for (int j = 0; j < N; ++j) p[(size_t)j * C] = x[j];
}

template <typename T, int BS>
__device__ __forceinline__ void load_soa_mat(T (&M)[BS][BS], const T* __restrict__ p, int C) {
  T x[BS * BS];
  load_soa<T, BS * BS>(x, p, C);
  unflatten<T, BS>(M, x);
}

template <typename T, int BS>
__device__ __forceinline__ void store_soa_mat(T* __restrict__ p, int C, const T (&M)[BS][BS]) {
  T x[BS * BS];
  flatten<T, BS>(x, M);
  store_soa<T, BS * BS>(p, C, x);
}

template <typename T, int BS>
__device__ __forceinline__ void set_identity(T (&M)[BS][BS]) {
#pragma unroll
  for (int i = 0; i < BS; ++i)
#pragma unroll
    for (int k = 0; k < BS; ++k) M[i][k] = (i == k) ? T(1) : T(0);
}

template <typename T, int BS>
__device__ __forceinline__ void set_zero(T (&M)[BS][BS]) {
#pragma unroll
  for (int i = 0; i < BS; ++i)
#pragma unroll
    for (int k = 0; k < BS; ++k) M[i][k] = T(0);
}

// R = X Y
template <typename T, int BS>
__device__ __forceinline__ void matmul(T (&R)[BS][BS], const T (&X)[BS][BS],
                                       const T (&Y)[BS][BS]) {
#pragma unroll
  for (int i = 0; i < BS; ++i)
#pragma unroll
    for (int j = 0; j < BS; ++j) {
      T s = T(0);
#pragma unroll
      for (int k = 0; k < BS; ++k) s += X[i][k] * Y[k][j];
      R[i][j] = s;
    }
}

// R = X Y' + Z
template <typename T, int BS>
__device__ __forceinline__ void matmul_nt_add(T (&R)[BS][BS], const T (&X)[BS][BS],
                                              const T (&Y)[BS][BS], const T (&Z)[BS][BS]) {
#pragma unroll
  for (int i = 0; i < BS; ++i)
#pragma unroll
    for (int j = 0; j < BS; ++j) {
      T s = T(0);
#pragma unroll
      for (int k = 0; k < BS; ++k) s += X[i][k] * Y[j][k];
      R[i][j] = s + Z[i][j];
    }
}

// Values a (chunk, channel) pair takes in the scratch (the wrappers in
// ops/fused_kalman.py allocate by the same widths).
enum { FWD_TOTAL = 0, FWD_CARRY = 1, BWD_TOTAL = 2, BWD_CARRY = 3 };
constexpr int kalman_scratch_values(int which, int bs) {
  return which == FWD_TOTAL ? 3 * bs * bs + 2 * bs  // At, b, Cm, eta, J
         : which == BWD_TOTAL ? 2 * bs * bs + bs    // E, g, L
         : (which == FWD_CARRY || which == BWD_CARRY) ? bs + bs * bs  // m, P
         : -1;
}
template <int WHICH, int BS> constexpr int SCRATCH = kalman_scratch_values(WHICH, BS);

// The chunk [t_lo, t_hi) of (chunk k, L steps a chunk, n_steps in all).
__device__ __forceinline__ void chunk_range(int k, int L, int n_steps, int& t_lo, int& t_hi) {
  t_lo = k * L;
  t_hi = min(t_lo + L, n_steps);
}

// ---------------------------------------------------------------------------
// K1: forward filter with fixed sites
// ---------------------------------------------------------------------------

// Pass 1: the totals of the chunks 0 .. n_tot-1 (all of them full; the last
// chunk's total is never used).
template <typename T, int BS>
__global__ void __launch_bounds__(KALMAN_THREADS)
fwd_totals_kernel(const T* __restrict__ ttau, const T* __restrict__ tnu,
                  const T* __restrict__ A_, const T* __restrict__ Q_,
                  const T* __restrict__ H_, T* __restrict__ tot, int L, int n_tot, int C) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= (long long)n_tot * C) return;
  const int k = (int)(tid / C), c = (int)(tid - (long long)k * C);
  T A[BS][BS], Q[BS][BS], H[BS];
  load_mat_v<T, BS>(A, A_ + (size_t)c * BS * BS);
  load_mat_v<T, BS>(Q, Q_ + (size_t)c * BS * BS);
  load_row<T, BS>(H, H_ + (size_t)c * BS);
  T At[BS][BS], b[BS], Cm[BS][BS], eta[BS], J[BS][BS];
  set_identity<T, BS>(At);
  set_zero<T, BS>(Cm);
  set_zero<T, BS>(J);
#pragma unroll
  for (int i = 0; i < BS; ++i) b[i] = eta[i] = T(0);

  size_t idx = (size_t)k * L * C + c;
  T tt_next = ttau[idx], tn_next = tnu[idx];
  for (int i = 0; i < L; ++i) {
    const T tt = tt_next, tn = tn_next;
    if (i + 1 < L) {
      idx += C;
      tt_next = ttau[idx];
      tn_next = tnu[idx];
    }
    T mp[BS], AP[BS][BS], Pp[BS][BS], Ap[BS][BS], PH[BS], h[BS], fmu, HPH;
    predict<T, BS>(A, Q, b, Cm, mp, AP, Pp);
    matmul<T, BS>(Ap, A, At);
    observe<T, BS>(H, mp, Pp, fmu, PH, HPH);
    const T z = tt * HPH + T(1);
    const T v = (tt * fmu - tn) / z;
    const T w = tt / z;
#pragma unroll
    for (int j = 0; j < BS; ++j) {
      T s = T(0);
#pragma unroll
      for (int r = 0; r < BS; ++r) s += H[r] * Ap[r][j];
      h[j] = s;
    }
#pragma unroll
    for (int j = 0; j < BS; ++j) eta[j] -= h[j] * v;
#pragma unroll
    for (int r = 0; r < BS; ++r)
#pragma unroll
      for (int j = 0; j < BS; ++j) {
        J[r][j] += w * h[r] * h[j];
        At[r][j] = Ap[r][j] - w * PH[r] * h[j];
      }
    site_update<T, BS>(tt, tn, fmu, HPH, PH, mp, Pp, b, Cm);
  }
  T* out = tot + (size_t)k * SCRATCH<FWD_TOTAL, BS> * C + c;
  store_soa_mat<T, BS>(out, C, At);
  store_soa<T, BS>(out + (size_t)(BS * BS) * C, C, b);
  store_soa_mat<T, BS>(out + (size_t)(BS * BS + BS) * C, C, Cm);
  store_soa<T, BS>(out + (size_t)(2 * BS * BS + BS) * C, C, eta);
  store_soa_mat<T, BS>(out + (size_t)(2 * BS * BS + 2 * BS) * C, C, J);
}

template <typename T, int BS> struct FwdTotal {
  T At[BS][BS], b[BS], Cm[BS][BS], eta[BS], J[BS][BS];
  __device__ __forceinline__ void load(const T* __restrict__ p, int C) {
    load_soa_mat<T, BS>(At, p, C);
    load_soa<T, BS>(b, p + (size_t)(BS * BS) * C, C);
    load_soa_mat<T, BS>(Cm, p + (size_t)(BS * BS + BS) * C, C);
    load_soa<T, BS>(eta, p + (size_t)(2 * BS * BS + BS) * C, C);
    load_soa_mat<T, BS>(J, p + (size_t)(2 * BS * BS + 2 * BS) * C, C);
  }
};

// X with M X = B (B has BS + 1 columns) by elimination with partial pivoting:
// the pivot row bubbles up by compare-and-swap of whole rows, so every index
// is a compile-time constant; a NaN never swaps and spreads by arithmetic.
// One division a pivot: the substitution multiplies by its reciprocal.
template <typename T, int BS>
__device__ __forceinline__ void solve_pivoted(T (&R)[BS][2 * BS + 1], T (&X)[BS][BS + 1]) {
  constexpr int NC = 2 * BS + 1;
  T inv[BS];
#pragma unroll
  for (int j = 0; j < BS; ++j) {
#pragma unroll
    for (int i = j + 1; i < BS; ++i) {
      const bool sw = Num<T>::abs_(R[i][j]) > Num<T>::abs_(R[j][j]);
#pragma unroll
      for (int q = j; q < NC; ++q) {
        const T top = R[j][q], low = R[i][q];
        R[j][q] = sw ? low : top;
        R[i][q] = sw ? top : low;
      }
    }
    inv[j] = T(1) / R[j][j];
#pragma unroll
    for (int i = j + 1; i < BS; ++i) {
      const T f = R[i][j] * inv[j];
#pragma unroll
      for (int q = j + 1; q < NC; ++q) R[i][q] -= f * R[j][q];
    }
  }
#pragma unroll
  for (int i = BS - 1; i >= 0; --i)
#pragma unroll
    for (int r = 0; r <= BS; ++r) {
      T s = R[i][BS + r];
#pragma unroll
      for (int q = i + 1; q < BS; ++q) s -= R[i][q] * X[q][r];
      X[i][r] = s * inv[i];
    }
}

// Pass 2: the state that enters the chunks 1 .. n_tot, from (0, Pinf);
// carry slot k-1 holds chunk k's.
template <typename T, int BS>
__global__ void __launch_bounds__(KALMAN_THREADS)
fwd_carry_kernel(const T* __restrict__ tot, const T* __restrict__ Pinf_,
                 T* __restrict__ carry, int n_tot, int C) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  T m[BS], P[BS][BS];
  load_mat_v<T, BS>(P, Pinf_ + (size_t)c * BS * BS);
#pragma unroll
  for (int i = 0; i < BS; ++i) m[i] = T(0);
  const size_t tot_stride = (size_t)SCRATCH<FWD_TOTAL, BS> * C;
  const size_t carry_stride = (size_t)SCRATCH<FWD_CARRY, BS> * C;
  FwdTotal<T, BS> nx;
  nx.load(tot + c, C);
  for (int k = 0; k < n_tot; ++k) {
    const FwdTotal<T, BS> e = nx;
    if (k + 1 < n_tot) nx.load(tot + (size_t)(k + 1) * tot_stride + c, C);
    // [I + P J | P | m + P eta]
    T R[BS][2 * BS + 1], X[BS][BS + 1];
#pragma unroll
    for (int i = 0; i < BS; ++i) {
#pragma unroll
      for (int j = 0; j < BS; ++j) {
        T s = (i == j) ? T(1) : T(0);
#pragma unroll
        for (int q = 0; q < BS; ++q) s += P[i][q] * e.J[q][j];
        R[i][j] = s;
        R[i][BS + j] = P[i][j];
      }
      T s = m[i];
#pragma unroll
      for (int q = 0; q < BS; ++q) s += P[i][q] * e.eta[q];
      R[i][2 * BS] = s;
    }
    solve_pivoted<T, BS>(R, X);
    T DP[BS][BS], ADP[BS][BS];
#pragma unroll
    for (int i = 0; i < BS; ++i)
#pragma unroll
      for (int j = 0; j < BS; ++j) DP[i][j] = T(0.5) * (X[i][j] + X[j][i]);
#pragma unroll
    for (int i = 0; i < BS; ++i) {
      T s = T(0);
#pragma unroll
      for (int q = 0; q < BS; ++q) s += e.At[i][q] * X[q][BS];
      m[i] = s + e.b[i];
    }
    matmul<T, BS>(ADP, e.At, DP);
    matmul_nt_add<T, BS>(P, ADP, e.At, e.Cm);
    T* out = carry + (size_t)k * carry_stride + c;
    store_soa<T, BS>(out, C, m);
    store_soa_mat<T, BS>(out + (size_t)BS * C, C, P);
  }
}

// Pass 3: the sequential filter inside every chunk, from its carry (chunk 0:
// from (0, Pinf)).  With one chunk this is the whole sequential pass.
template <typename T, int BS>
__global__ void __launch_bounds__(KALMAN_THREADS)
fwd_emit_kernel(const T* __restrict__ ttau, const T* __restrict__ tnu,
                const T* __restrict__ A_, const T* __restrict__ Q_,
                const T* __restrict__ Pinf_, const T* __restrict__ H_,
                const T* __restrict__ carry, T* __restrict__ ms, T* __restrict__ Ps,
                int n_steps, int L, int nc, int C) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= (long long)nc * C) return;
  const int k = (int)(tid / C), c = (int)(tid - (long long)k * C);
  int t_lo, t_hi;
  chunk_range(k, L, n_steps, t_lo, t_hi);
  T A[BS][BS], Q[BS][BS], P[BS][BS], H[BS], m[BS];
  load_mat_v<T, BS>(A, A_ + (size_t)c * BS * BS);
  load_mat_v<T, BS>(Q, Q_ + (size_t)c * BS * BS);
  load_row<T, BS>(H, H_ + (size_t)c * BS);
  if (k == 0) {
    load_mat_v<T, BS>(P, Pinf_ + (size_t)c * BS * BS);  // start from (0, Pinf)
#pragma unroll
    for (int i = 0; i < BS; ++i) m[i] = T(0);
  } else {
    const T* in = carry + (size_t)(k - 1) * SCRATCH<FWD_CARRY, BS> * C + c;
    load_soa<T, BS>(m, in, C);
    load_soa_mat<T, BS>(P, in + (size_t)BS * C, C);
  }
  size_t row = (size_t)t_lo * C + c;
  T tt_next = ttau[row], tn_next = tnu[row];
  for (int t = t_lo; t < t_hi; ++t, row += C) {
    const T tt = tt_next, tn = tn_next;
    if (t + 1 < t_hi) {
      tt_next = ttau[row + C];
      tn_next = tnu[row + C];
    }
    // Predict at every step, the first included: from (0, Pinf) with the
    // stationary Q = Pinf - A Pinf A' that is an exact no-op.
    T mp[BS], AP[BS][BS], Pp[BS][BS], PH[BS], fmu, HPH;
    predict<T, BS>(A, Q, m, P, mp, AP, Pp);
    observe<T, BS>(H, mp, Pp, fmu, PH, HPH);
    site_update<T, BS>(tt, tn, fmu, HPH, PH, mp, Pp, m, P);
    store_row<T, BS>(ms + row * BS, m);
    store_mat_v<T, BS>(Ps + row * BS * BS, P);
  }
}

// ---------------------------------------------------------------------------
// K2: RTS smoother over a stored filtered trajectory
// ---------------------------------------------------------------------------

// One smoother step on the carry (mn, Pn) from the filtered (m, P) of step t:
//   mn <- m + G (mn - A m),  Pn <- P + G (Pn - Pp) G',  and E <- G E if asked.
template <typename T, int BS, bool WITH_E>
__device__ __forceinline__ void smoother_step(const T (&A)[BS][BS], const T (&Q)[BS][BS],
                                              const T (&pad)[BS], const T (&m)[BS],
                                              const T (&P)[BS][BS], T (&mn)[BS],
                                              T (&Pn)[BS][BS], T (&E)[BS][BS]) {
  T Am[BS], AP[BS][BS], Pp[BS][BS];
  predict<T, BS>(A, Q, m, P, Am, AP, Pp);

  // Unrolled Cholesky of Pp + diag(pad) with a 1e-30 pivot floor.  Padded
  // dims have zero rows/columns in Pp, so pad = 1 keeps them nonsingular.
  T Lc[BS][BS], inv_d[BS];
#pragma unroll
  for (int j = 0; j < BS; ++j) {
    T s = Pp[j][j] + pad[j];
#pragma unroll
    for (int k = 0; k < j; ++k) s -= Lc[j][k] * Lc[j][k];
    const T d = Num<T>::sqrt_(clamp_min(s, T(1e-30)));
    Lc[j][j] = d;
    inv_d[j] = T(1) / d;
#pragma unroll
    for (int i = j + 1; i < BS; ++i) {
      T r = Pp[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) r -= Lc[i][k] * Lc[j][k];
      Lc[i][j] = r * inv_d[j];
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
      for (int k = 0; k < i; ++k) s -= Lc[i][k] * yv[k];
      yv[i] = s * inv_d[i];
    }
#pragma unroll
    for (int i = BS - 1; i >= 0; --i) {
      T s = yv[i];
#pragma unroll
      for (int k = i + 1; k < BS; ++k) s -= Lc[k][i] * G[l][k];
      G[l][i] = s * inv_d[i];
    }
  }
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
  matmul<T, BS>(GdP, G, dP);
  matmul_nt_add<T, BS>(Pn, GdP, G, P);
  if constexpr (WITH_E) {
    T GE[BS][BS];
    matmul<T, BS>(GE, G, E);
#pragma unroll
    for (int i = 0; i < BS; ++i)
#pragma unroll
      for (int k = 0; k < BS; ++k) E[i][k] = GE[i][k];
  }
}

// The walk down a chunk shared by passes 1 and 3: filtered moments loaded
// one step ahead, the step, and (pass 3) the stores.
template <typename T, int BS, bool EMIT>
__device__ __forceinline__ void smoother_walk(const T* __restrict__ ms,
                                              const T* __restrict__ Ps, const T (&A)[BS][BS],
                                              const T (&Q)[BS][BS], const T (&pad)[BS],
                                              T (&m_nx)[BS], T (&P_nx)[BS][BS], T (&mn)[BS],
                                              T (&Pn)[BS][BS], T (&E)[BS][BS],
                                              T* __restrict__ sm, T* __restrict__ sP, int t_lo,
                                              int t_hi, int C, int c) {
  for (int t = t_hi - 1; t >= t_lo; --t) {
    const size_t row = (size_t)t * C + c;
    T m[BS], P[BS][BS];
#pragma unroll
    for (int i = 0; i < BS; ++i) m[i] = m_nx[i];
#pragma unroll
    for (int i = 0; i < BS; ++i)
#pragma unroll
      for (int k = 0; k < BS; ++k) P[i][k] = P_nx[i][k];
    if (t > t_lo) {
      const size_t prev = row - C;
      load_row<T, BS>(m_nx, ms + prev * BS);
      load_mat_v<T, BS>(P_nx, Ps + prev * BS * BS);
    }
    smoother_step<T, BS, !EMIT>(A, Q, pad, m, P, mn, Pn, E);
    if constexpr (EMIT) {
      store_row<T, BS>(sm + row * BS, mn);
      store_mat_v<T, BS>(sP + row * BS * BS, Pn);
    }
  }
}

// Pass 1: the totals of the chunks 1 .. nc-1 (the last one may be short;
// chunk 0's total is never used).  Slot k-1 holds chunk k's.
template <typename T, int BS>
__global__ void __launch_bounds__(KALMAN_THREADS)
bwd_totals_kernel(const T* __restrict__ ms, const T* __restrict__ Ps,
                  const T* __restrict__ A_, const T* __restrict__ Q_,
                  const T* __restrict__ pad_, T* __restrict__ tot, int n_steps, int L,
                  int nc, int C) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= (long long)(nc - 1) * C) return;
  const int k = (int)(tid / C) + 1, c = (int)(tid - (long long)(k - 1) * C);
  int t_lo, t_hi;
  chunk_range(k, L, n_steps, t_lo, t_hi);
  T A[BS][BS], Q[BS][BS], pad[BS];
  load_mat_v<T, BS>(A, A_ + (size_t)c * BS * BS);
  load_mat_v<T, BS>(Q, Q_ + (size_t)c * BS * BS);
  load_row<T, BS>(pad, pad_ + (size_t)c * BS);
  T m_nx[BS], P_nx[BS][BS], g[BS], Lt[BS][BS], E[BS][BS];
  const size_t last = (size_t)(t_hi - 1) * C + c;
  load_row<T, BS>(m_nx, ms + last * BS);
  load_mat_v<T, BS>(P_nx, Ps + last * BS * BS);
  set_identity<T, BS>(E);
  set_zero<T, BS>(Lt);
#pragma unroll
  for (int i = 0; i < BS; ++i) g[i] = T(0);
  smoother_walk<T, BS, false>(ms, Ps, A, Q, pad, m_nx, P_nx, g, Lt, E, nullptr, nullptr, t_lo,
                              t_hi, C, c);
  T* out = tot + (size_t)(k - 1) * SCRATCH<BWD_TOTAL, BS> * C + c;
  store_soa_mat<T, BS>(out, C, E);
  store_soa<T, BS>(out + (size_t)(BS * BS) * C, C, g);
  store_soa_mat<T, BS>(out + (size_t)(BS * BS + BS) * C, C, Lt);
}

// The carry above the last step, which makes its smoothed moments equal its
// filtered ones: mn = A m_last, Pn = A P_last A' + Q.
template <typename T, int BS>
__device__ __forceinline__ void last_carry(const T* __restrict__ ms, const T* __restrict__ Ps,
                                           const T (&A)[BS][BS], const T (&Q)[BS][BS],
                                           int n_steps, int C, int c, T (&mn)[BS],
                                           T (&Pn)[BS][BS]) {
  T m[BS], P[BS][BS], AP[BS][BS];
  const size_t row = (size_t)(n_steps - 1) * C + c;
  load_row<T, BS>(m, ms + row * BS);
  load_mat_v<T, BS>(P, Ps + row * BS * BS);
  predict<T, BS>(A, Q, m, P, mn, AP, Pn);
}

// Pass 2: the carry that enters the chunks nc-2 .. 0 from above; carry slot
// k holds chunk k's.
template <typename T, int BS>
__global__ void __launch_bounds__(KALMAN_THREADS)
bwd_carry_kernel(const T* __restrict__ ms, const T* __restrict__ Ps,
                 const T* __restrict__ A_, const T* __restrict__ Q_,
                 const T* __restrict__ tot, T* __restrict__ carry, int n_steps, int nc,
                 int C) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  T mn[BS], Pn[BS][BS];
  {
    T A[BS][BS], Q[BS][BS];
    load_mat_v<T, BS>(A, A_ + (size_t)c * BS * BS);
    load_mat_v<T, BS>(Q, Q_ + (size_t)c * BS * BS);
    last_carry<T, BS>(ms, Ps, A, Q, n_steps, C, c, mn, Pn);
  }
  const size_t tot_stride = (size_t)SCRATCH<BWD_TOTAL, BS> * C;
  const size_t carry_stride = (size_t)SCRATCH<BWD_CARRY, BS> * C;
  T E_nx[BS][BS], g_nx[BS], L_nx[BS][BS];
  auto load_total = [&](int k) {  // chunk k's total is in slot k-1
    const T* in = tot + (size_t)(k - 1) * tot_stride + c;
    load_soa_mat<T, BS>(E_nx, in, C);
    load_soa<T, BS>(g_nx, in + (size_t)(BS * BS) * C, C);
    load_soa_mat<T, BS>(L_nx, in + (size_t)(BS * BS + BS) * C, C);
  };
  load_total(nc - 1);
  for (int k = nc - 1; k >= 1; --k) {
    T E[BS][BS], g[BS], Lt[BS][BS], EP[BS][BS], m_new[BS];
#pragma unroll
    for (int i = 0; i < BS; ++i) {
      g[i] = g_nx[i];
#pragma unroll
      for (int j = 0; j < BS; ++j) {
        E[i][j] = E_nx[i][j];
        Lt[i][j] = L_nx[i][j];
      }
    }
    if (k > 1) load_total(k - 1);
#pragma unroll
    for (int i = 0; i < BS; ++i) {
      T s = T(0);
#pragma unroll
      for (int q = 0; q < BS; ++q) s += E[i][q] * mn[q];
      m_new[i] = s + g[i];
    }
#pragma unroll
    for (int i = 0; i < BS; ++i) mn[i] = m_new[i];
    matmul<T, BS>(EP, E, Pn);
    matmul_nt_add<T, BS>(Pn, EP, E, Lt);
    T* out = carry + (size_t)(k - 1) * carry_stride + c;
    store_soa<T, BS>(out, C, mn);
    store_soa_mat<T, BS>(out + (size_t)BS * C, C, Pn);
  }
}

// Pass 3: the sequential smoother inside every chunk, from its carry (the
// last chunk: from the last step's prediction).  With one chunk this is the
// whole sequential pass.
template <typename T, int BS>
__global__ void __launch_bounds__(KALMAN_THREADS)
bwd_emit_kernel(const T* __restrict__ ms, const T* __restrict__ Ps,
                const T* __restrict__ A_, const T* __restrict__ Q_,
                const T* __restrict__ pad_, const T* __restrict__ carry,
                T* __restrict__ sm, T* __restrict__ sP, int n_steps, int L, int nc, int C) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= (long long)nc * C) return;
  const int k = (int)(tid / C), c = (int)(tid - (long long)k * C);
  int t_lo, t_hi;
  chunk_range(k, L, n_steps, t_lo, t_hi);
  T A[BS][BS], Q[BS][BS], pad[BS];
  load_mat_v<T, BS>(A, A_ + (size_t)c * BS * BS);
  load_mat_v<T, BS>(Q, Q_ + (size_t)c * BS * BS);
  load_row<T, BS>(pad, pad_ + (size_t)c * BS);
  T m_nx[BS], P_nx[BS][BS], mn[BS], Pn[BS][BS], E[BS][BS];
  if (k == nc - 1) {
    last_carry<T, BS>(ms, Ps, A, Q, n_steps, C, c, mn, Pn);
  } else {
    const T* in = carry + (size_t)k * SCRATCH<BWD_CARRY, BS> * C + c;
    load_soa<T, BS>(mn, in, C);
    load_soa_mat<T, BS>(Pn, in + (size_t)BS * C, C);
  }
  const size_t last = (size_t)(t_hi - 1) * C + c;
  load_row<T, BS>(m_nx, ms + last * BS);
  load_mat_v<T, BS>(P_nx, Ps + last * BS * BS);
  smoother_walk<T, BS, true>(ms, Ps, A, Q, pad, m_nx, P_nx, mn, Pn, E, sm, sP, t_lo, t_hi, C,
                             c);
}

// ---------------------------------------------------------------------------
// Launchers: three launches on one stream (one when there is one chunk)
// ---------------------------------------------------------------------------

inline int blocks_for(long long threads) {
  return (int)((threads + KALMAN_THREADS - 1) / KALMAN_THREADS);
}

template <typename T, int BS>
int launch_fwd(const void* ttau, const void* tnu, const void* A, const void* Q,
               const void* Pinf, const void* H, void* ms, void* Ps, void* tot, void* carry,
               int n_steps, int C, int L, cudaStream_t st) {
  const int nc = (n_steps + L - 1) / L;
  if (nc > 1) {
    fwd_totals_kernel<T, BS><<<blocks_for((long long)(nc - 1) * C), KALMAN_THREADS, 0, st>>>(
        (const T*)ttau, (const T*)tnu, (const T*)A, (const T*)Q, (const T*)H, (T*)tot, L,
        nc - 1, C);
    int rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
    fwd_carry_kernel<T, BS><<<blocks_for(C), KALMAN_THREADS, 0, st>>>(
        (const T*)tot, (const T*)Pinf, (T*)carry, nc - 1, C);
    rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
  }
  fwd_emit_kernel<T, BS><<<blocks_for((long long)nc * C), KALMAN_THREADS, 0, st>>>(
      (const T*)ttau, (const T*)tnu, (const T*)A, (const T*)Q, (const T*)Pinf, (const T*)H,
      (const T*)carry, (T*)ms, (T*)Ps, n_steps, L, nc, C);
  return (int)cudaGetLastError();
}

template <typename T, int BS>
int launch_bwd(const void* ms, const void* Ps, const void* A, const void* Q,
               const void* pad, void* sm, void* sP, void* tot, void* carry, int n_steps, int C,
               int L, cudaStream_t st) {
  const int nc = (n_steps + L - 1) / L;
  if (nc > 1) {
    bwd_totals_kernel<T, BS><<<blocks_for((long long)(nc - 1) * C), KALMAN_THREADS, 0, st>>>(
        (const T*)ms, (const T*)Ps, (const T*)A, (const T*)Q, (const T*)pad, (T*)tot, n_steps,
        L, nc, C);
    int rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
    bwd_carry_kernel<T, BS><<<blocks_for(C), KALMAN_THREADS, 0, st>>>(
        (const T*)ms, (const T*)Ps, (const T*)A, (const T*)Q, (const T*)tot, (T*)carry,
        n_steps, nc, C);
    rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
  }
  bwd_emit_kernel<T, BS><<<blocks_for((long long)nc * C), KALMAN_THREADS, 0, st>>>(
      (const T*)ms, (const T*)Ps, (const T*)A, (const T*)Q, (const T*)pad, (const T*)carry,
      (T*)sm, (T*)sP, n_steps, L, nc, C);
  return (int)cudaGetLastError();
}

}  // namespace


// The C entry points of one dtype: nsgp_fused_fwd_<SUFFIX>, nsgp_fused_bwd_<SUFFIX>.
// tot, carry: scratch of (chunks - 1) * kalman_scratch_values(...) * C values
// each; unused, and may be null, with one chunk (n_steps <= chunk).
#define NSGP_DEFINE_FUSED_FWD(SUFFIX, T)                                                     \
  extern "C" int nsgp_fused_fwd_##SUFFIX(                                                    \
      int bs, const void* ttau, const void* tnu, const void* A, const void* Q,               \
      const void* Pinf, const void* H, void* ms, void* Ps, void* tot, void* carry,           \
      int n_steps, int C, int chunk, void* stream) {                                         \
    cudaStream_t st = (cudaStream_t)stream;                                                  \
    if (n_steps < 1 || C < 1 || chunk < 1) return -1;                                        \
    NSGP_DISPATCH_BS(launch_fwd, T, ttau, tnu, A, Q, Pinf, H, ms, Ps, tot, carry, n_steps,   \
                     C, chunk, st)                                                           \
  }

#define NSGP_DEFINE_FUSED_BWD(SUFFIX, T)                                                     \
  extern "C" int nsgp_fused_bwd_##SUFFIX(                                                    \
      int bs, const void* ms, const void* Ps, const void* A, const void* Q, const void* pad, \
      void* sm, void* sP, void* tot, void* carry, int n_steps, int C, int chunk,             \
      void* stream) {                                                                        \
    cudaStream_t st = (cudaStream_t)stream;                                                  \
    if (n_steps < 1 || C < 1 || chunk < 1) return -1;                                        \
    NSGP_DISPATCH_BS(launch_bwd, T, ms, Ps, A, Q, pad, sm, sP, tot, carry, n_steps, C,       \
                     chunk, st)                                                              \
  }
