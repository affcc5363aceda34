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
// can start.  Bytes and operations are orders of magnitude below the card's
// rates; what counts is the latency of a reverse step on one SM.  But most
// of a reverse step does not depend on that cotangent: the prediction from
// the stored (ms, Ps)[t-1], the moment match, the site's forward scalars and
// every sigma point's value depend only on the forward trajectory.
//
// What the design does about it: two launches of one kernel template, its
// PART the only difference.
//
// * The pre-pass (PART = VJP_PREPASS), a persistent grid over the steps,
//   one CTA a step at a time.  It re-derives step t from (ms, Ps)[t-1]
//   ((0, Pinf) at t = 0) with K3's own code and thread map (adf_step.cuh's
//   publish and match), so the totals are the forward's, and writes a record
//   of the step (VjpRecord): a header (Z, its floors, the merged shift, y,
//   observed), each channel's marginal, site scalars and prediction, and,
//   where the wrapper stashes, each sigma point's amplitudes, 'sq' factors,
//   weight at the merged shift, residual over s2e, 1 / s2e, link values and
//   the link's derivative: what match_vjp forms before a cotangent enters.
// * The reverse walk (PART = VJP_WALK), one CTA of ADF_THREADS in K3's thread
//   map, carries only the cotangent.  A ring of VJP_NSTAGE slots in shared
//   memory holds steps t, t-1, t-2: each slot the step's record and its
//   (ms, Ps)[t-1], g_tt, g_tn and g_lZ, filled by cp.async a step ahead by
//   warps with nothing else to do, so no global load sits on the chain (g_ms
//   and g_Ps, null on the training path, are read in place).  A step: the
//   channel threads (warp 0) run the update, the site and log Z backwards;
//   barrier A; the points' cotangents; barrier B; warp 0 runs the
//   observation and the prediction backwards.  With the per-point record,
//   warps 1 .. nwp take the points, one round (the wrapper stashes only where
//   S fits it): each lane reads its points from the ring before barrier A,
//   while warp 0 works, keeps only the cotangent algebra between the
//   barriers, merges the lanes' sums by recursive halving, and adds W's
//   cotangent after barrier B, while warp 0 works again; warp 0 adds its
//   step's A, Q and H cotangents to the float64 sums between the next step's
//   barriers, where it would wait.  Without the per-point record (many
//   points, or a record over the wrapper's byte budget) every warp
//   re-evaluates the points with adf_step.cuh's match_vjp at the recorded
//   shift.
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
//
// With -DNSGP_CLOCK_PROBE thread 0 (a channel thread) and thread 32 (a lane
// of the points) of the walk add up clock64() per phase and write the sums to
// `cyc` (tools/probe_adf_cycles.py --kernel vjp).

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
  T* rec;           // the pre-pass's record, a block of VjpRecord::blk a step
  int stash;        // the blocks hold the per-point part
};

constexpr int VJP_PREPASS = 0, VJP_WALK = 1;  // the kernel's two parts
constexpr int VJP_NSTAGE = 3;                 // the walk's ring: steps t, t-1, t-2

// A step's record: the header, then each channel's scalars (VJP_CW) and,
// where the ring holds it (VjpRecord::pred), its prediction mp, PH, AP, Pp,
// each padded to a multiple of four values.  The walk reads reciprocals
// (1 / Z0, 1 / z, 1 / denom, 1 / sd) where the forward divides, so that no
// division sits on its chain.
enum VjpHeader {
  VH_Z, VH_IZ0, VH_E, VH_ZI, VH_FLOOR, VH_TINY, VH_MALL, VH_OBS, VH_Y, VJP_HDR = 12
};
enum VjpChannel {
  VC_FMU, VC_VAR, VC_SD, VC_TT, VC_TN, VC_R, VC_IDEN, VC_D2, VC_DL, VC_S1, VC_S2, VC_X1, VC_X2,
  VC_RG, VC_IS2, VC_IZ, VC_V, VC_W, VC_ISD, VJP_CW = 20
};

// Offsets (elements of T) inside a step's block; every array starts on 16
// bytes.  The per-point part, where stashed: a, h [Sp][Dp] (a point's
// amplitudes after 'sq' and, for 'sq', 0.5 / a where the floor does not
// bind, else 0), sc [Sp][4] (its weight at the merged shift, residual over
// s2e, 1 / s2e, and rs^2 - 1 / s2e), lk, dlk [Sp][Np] (link values and the
// link's derivative at each modulator).
struct VjpRecord {
  int pred, bsp, bbp, cw, Sp, Dp, Np, step, a, h, sc, lk, dlk, blk;
};

__host__ __device__ inline VjpRecord vjp_record(int D, int N, int S, int BS, int stash, int pred) {
  AdfLayout L;
  adf_lane_map(L, D, N, ADF_PB_ONE);
  VjpRecord r;
  r.pred = pred;
  r.bsp = adf_r4(BS);
  r.bbp = adf_r4(BS * BS);
  r.cw = VJP_CW + (pred ? 2 * r.bsp + 2 * r.bbp : 0);
  r.Sp = adf_r4(S);
  r.Dp = L.Dp;
  r.Np = adf_r4(N);
  r.step = VJP_HDR + (D + N) * r.cw;
  r.a = r.step;
  r.h = r.a + r.Sp * r.Dp;
  r.sc = r.h + r.Sp * r.Dp;
  r.lk = r.sc + 4 * r.Sp;
  r.dlk = r.lk + r.Sp * r.Np;
  r.blk = stash ? r.dlk + r.Sp * r.Np : r.step;
  return r;
}

// K7's shared memory after the sweep's layout: offsets in elements of T,
// then the float64 part from byte `dbl` (the sn2 partials, then the sums if
// they fit: npar a channel, [npar][C], then W's [N][DB][threads]).  The
// pre-pass takes the part before `mdl`.  The walk stages there each
// channel's A, Q, H (mw values a channel), then holds its channels' pending
// parameter cotangents ([C][npar], pend) and its ring: a slot holds a step's
// block, then its m0, P0, g_tt, g_tn and g_lZ.
struct VjpLayout {
  int g4, zi, zd, scal, lkbar, mdl, mw, pend, ring, slot, m0, P0, gtt, gtn, glZ;
  VjpRecord R;
  size_t dbl;
  int npar, nw, sums_shared;
  size_t bytes;
};

__host__ __device__ inline VjpLayout vjp_layout_with(int D, int N, int S, int BS, size_t elem,
                                                     int stash, int pred) {
  const AdfLayout L = adf_layout(D, N, S, 1, elem);
  const int C = D + N;
  VjpLayout V;
  V.R = vjp_record(D, N, S, BS, stash, pred);
  V.npar = 2 * BS * BS + BS;
  int o = L.total;
  V.g4 = o; o += 4 * L.Dp;  // the totals' cotangents: A1, A2, X1, X2
  V.zi = o; o += adf_r4(C);  // the warps' shares of Zi's and Z's
  V.zd = o; o += adf_r4(C);
  V.scal = o; o += 8;  // the pre-pass's merged shift
  V.lkbar = o; o += adf_r4(ADF_NW * N * L.PT);  // the warps' link cotangents
  V.mw = 2 * V.R.bbp + V.R.bsp;
  V.mdl = o; o += C * V.mw;
  V.pend = o; o += adf_r4(C * V.npar);
  int s = V.R.blk;
  V.m0 = s; s += adf_r4(C * BS);
  V.P0 = s; s += adf_r4(C * BS * BS);
  V.gtt = s; s += adf_r4(C);
  V.gtn = s; s += adf_r4(C);
  V.glZ = s; s += 4;
  V.slot = s;
  V.ring = o; o += VJP_NSTAGE * s;
  V.dbl = ((size_t)o * elem + 15) & ~(size_t)15;
  V.nw = N * ADF_DB * ADF_THREADS;
  const size_t sums = ((size_t)C * V.npar + V.nw) * sizeof(double);
  const size_t base = V.dbl + ADF_THREADS * sizeof(double);
  V.sums_shared = base + sums <= ADF_SMEM_MAX;
  V.bytes = base + (V.sums_shared ? sums : 0);
  return V;
}

// The layout, with the prediction in the record where the ring then fits.
__host__ __device__ inline VjpLayout vjp_layout(int D, int N, int S, int BS, size_t elem,
                                                int stash) {
  const VjpLayout V = vjp_layout_with(D, N, S, BS, elem, stash, 1);
  return V.bytes <= ADF_SMEM_MAX ? V : vjp_layout_with(D, N, S, BS, elem, stash, 0);
}

// The points the stashed walk takes: one round over warps 1 .. NW-1.
__host__ __device__ inline int vjp_stash_points(int D, int N) {
  AdfLayout L;
  adf_lane_map(L, D, N, ADF_PB_ONE);
  return (ADF_NW - 1) * L.GW * ADF_PB_ONE;
}

// Whether the walk can read the per-point record: the points fit its round,
// the ring with them and the float64 sums fit shared memory.
__host__ __device__ inline bool vjp_can_stash(int D, int N, int S, int BS, size_t elem) {
  const VjpLayout V = vjp_layout(D, N, S, BS, elem, 1);
  return S <= vjp_stash_points(D, N) && V.sums_shared && V.bytes <= ADF_SMEM_MAX;
}

// float64 sums the wrapper's scratch must hold: the same as in shared memory.
__host__ inline size_t vjp_scratch_doubles(int D, int N, int BS) {
  return (size_t)(D + N) * (2 * BS * BS + BS) + (size_t)N * ADF_DB * ADF_THREADS;
}

// n values from 16-byte aligned src, four at a time.
template <typename T, int n>
__device__ __forceinline__ void load_vec(T* dst, const T* src) {
#pragma unroll
  for (int i = 0; i < n; i += 4) {
    const Pack<T, 4> v = *reinterpret_cast<const Pack<T, 4>*>(src + i);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (i + k < n) dst[i + k] = v.v[k];
  }
}

template <typename T, int BS>
__device__ __forceinline__ void load_mat_vec(T (&M)[BS][BS], const T* src) {
  T flat[BS * BS];
  load_vec<T, BS * BS>(flat, src);
#pragma unroll
  for (int i = 0; i < BS; ++i)
#pragma unroll
    for (int j = 0; j < BS; ++j) M[i][j] = flat[i * BS + j];
}

// ---------------------------------------------------------------------------
// The pre-pass
// ---------------------------------------------------------------------------

// The per-point part of step t's record, after match: every point at the
// merged shift m_all, K3's lane map, as match_vjp evaluates it before a
// cotangent enters.
template <typename T, int PB>
__device__ __forceinline__ void vjp_record_points(const AdfStep<T, PB>& st, const VjpRecord& R,
                                                  T* blk, T yk, T m_all) {
  constexpr int DB = ADF_DB;
  const int N = st.N, S = st.S, PT = st.L.PT, d0 = st.d0, grp = st.grp;
  const Pack<T, DB> hz = *reinterpret_cast<const Pack<T, DB>*>(st.hph_z + d0);
  const Pack<T, DB> mz = *reinterpret_cast<const Pack<T, DB>*>(st.fmu_z + d0);
  for (int k = 0;; ++k) {
    const int s0 = st.first_point(k);
    if (s0 >= S) break;  // uniform over the warp
    const T* xi_w = st.xi_rows(k, s0);
    const T* wn_w = st.wn_rows(k, s0);
    st.link_values(s0, xi_w);
    __syncwarp();
    for (int idx = st.lane; idx < (N << st.L.lgPT); idx += 32) {
      const int pt = idx & (PT - 1), n = idx >> st.L.lgPT;
      if (s0 + pt < S) {
        const T lk = st.lk_w[n * PT + pt];
        const size_t at = (size_t)(s0 + pt) * R.Np + n;
        blk[R.lk + at] = lk;
        blk[R.dlk + at] =
            st.link_exp ? lk
                        : T(1) / (T(1) + Num<T>::exp_(-(st.mu_g[n] + st.sd_g[n] * xi_w[pt * N + n])));
      }
    }
    T a[PB][DB], ar[PB][DB], se[PB], mean[PB];
    st.amplitudes(a);
#pragma unroll
    for (int p = 0; p < PB; ++p)
#pragma unroll
      for (int j = 0; j < DB; ++j) ar[p][j] = a[p][j];
    st.point_sums(a, hz, mz, se, mean);
#pragma unroll
    for (int p = 0; p < PB; ++p) {
      const int pt = grp * PB + p, s = s0 + pt;
      if (s < S) {
        T rs, inv, ln;
        st.scalars(yk, se[p], mean[p], rs, inv, ln);
        Pack<T, DB> av, hv;
#pragma unroll
        for (int j = 0; j < DB; ++j) {
          av.v[j] = a[p][j];
          hv.v[j] = st.sq && ar[p][j] >= st.sq_floor ? T(0.5) / a[p][j] : T(0);
        }
        *reinterpret_cast<Pack<T, DB>*>(blk + R.a + (size_t)s * R.Dp + d0) = av;
        *reinterpret_cast<Pack<T, DB>*>(blk + R.h + (size_t)s * R.Dp + d0) = hv;
        if (st.g_lane == 0) {
          Pack<T, 4> sv;
          sv.v[0] = wn_w[pt] * st.weight(true, ln, m_all);
          sv.v[1] = rs;
          sv.v[2] = inv;
          sv.v[3] = rs * rs - inv;
          *reinterpret_cast<Pack<T, 4>*>(blk + R.sc + 4 * (size_t)s) = sv;
        }
      }
    }
    __syncwarp();  // the stash may be overwritten by the next round
  }
}

template <typename T, int BS>
__device__ __forceinline__ void vjp_prepass(const AdfCore<T>& core, const VjpArgs<T>& va) {
  constexpr int PB = ADF_PB_ONE, BB = BS * BS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sh = reinterpret_cast<T*>(smem_raw);
  const AdfStep<T, PB> st(core, 0, 1, sh);
  const int D = core.D, N = core.N, C = D + N;
  const VjpLayout V = vjp_layout(D, N, core.S, BS, sizeof(T), va.stash);
  const VjpRecord& R = V.R;
  const int tid = st.tid, c = tid;
  const bool chan = st.chan, mod = tid >= D;
  T* scal = sh + V.scal;
  const T tiny = Num<T>::tiny(), log_floor = core.log_floor, damp = core.damp;
  T A[BS][BS], Q[BS][BS], H[BS];
  if (chan) {
    load_mat<T, BS>(A, va.A + (size_t)c * BB);
    load_mat<T, BS>(Q, va.Q + (size_t)c * BB);
#pragma unroll
    for (int i = 0; i < BS; ++i) H[i] = va.H[(size_t)c * BS + i];
  }
  AdfProbe probe(false);
  __syncthreads();

  for (int t = blockIdx.x; t < core.n_steps; t += gridDim.x) {
    const T yk = core.y[t];
    const bool observed = core.obs[t] > T(0);  // uniform over the CTA
    T* blk = va.rec + (size_t)t * R.blk;
    T* cr = blk + VJP_HDR + c * R.cw;  // channel c's part of the record

    // ---- step t's prediction and marginal, from (ms, Ps)[t-1] or (0, Pinf)
    T fmu = T(0), var = T(0), sd = T(0);
    if (chan) {
      T m0[BS], P0[BS][BS], mp[BS], AP[BS][BS], Pp[BS][BS], PH[BS];
      if (t > 0) {
        const size_t row = (size_t)(t - 1) * C + c;
#pragma unroll
        for (int i = 0; i < BS; ++i) m0[i] = va.ms[row * BS + i];
        load_mat<T, BS>(P0, va.Ps + row * BB);
      } else {
#pragma unroll
        for (int i = 0; i < BS; ++i) m0[i] = T(0);
        load_mat<T, BS>(P0, va.Pinf + (size_t)c * BB);
      }
      predict<T, BS>(A, Q, m0, P0, mp, AP, Pp);
      observe<T, BS>(H, mp, Pp, fmu, PH, var);
      if (observed) st.publish(fmu, var, sd);
      if (R.pred) {
        T* pr = cr + VJP_CW;
#pragma unroll
        for (int i = 0; i < BS; ++i) {
          pr[i] = mp[i];
          pr[R.bsp + i] = PH[i];
        }
        store_mat<T, BS>(pr + 2 * R.bsp, AP);
        store_mat<T, BS>(pr + 2 * R.bsp + R.bbp, Pp);
      }
    }

    // ---- the totals of the sigma points (K3's code and merge order) ------
    T tot[3] = {T(0), T(0), T(0)}, m_all = T(0);
    if (observed) st.match(yk, 0, tot, m_all, probe);

    // ---- the site's forward scalars, as K3's adf_derivatives and advance --
    if (chan) {
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
      const T z = tt * var + T(1);
      const T vals[VJP_CW] = {fmu, var, sd, tt, tn, r, T(1) / denom, d2, dl, S1, S2, X1, X2, rg,
                              is2, T(1) / z, (tt * fmu - tn) / z, tt / z, T(1) / sd, T(0)};
#pragma unroll
      for (int i = 0; i < VJP_CW; ++i) cr[i] = vals[i];
      if (c == 0) {
        const T hd[VJP_HDR] = {Z, T(1) / Z0, e, Zi, lZ_raw >= log_floor ? T(1) : T(0),
                               Z >= tiny ? T(1) : T(0), mall, observed ? T(1) : T(0), yk,
                               T(0), T(0), T(0)};
#pragma unroll
        for (int i = 0; i < VJP_HDR; ++i) blk[i] = hd[i];
        scal[0] = mall;
      }
    }

    // ---- every point at the merged shift -----------------------------------
    if (va.stash && observed) {
      __syncthreads();
      vjp_record_points<T, PB>(st, R, blk, yk, scal[0]);
    }
    __syncthreads();  // the next step's publish overwrites the marginals
  }
}

// ---------------------------------------------------------------------------
// The reverse walk
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

template <int B>
__device__ __forceinline__ void cp_async_small(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "n"(B)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Step u into a ring slot, thread tid of NT its share: the record's block in
// 16-byte pieces, (ms, Ps)[u-1] or (0, Pinf), g_tt, g_tn and g_lZ.  A null
// cotangent's segment keeps the zeros the walk wrote at its start.
template <typename T, int BS>
__device__ __forceinline__ void vjp_fetch(const VjpArgs<T>& va, const VjpLayout& V, int C, int u,
                                          T* slot, int tid, int NT) {
  constexpr int PER = 16 / sizeof(T), E = sizeof(T);
  const T* blk = va.rec + (size_t)u * V.R.blk;
  for (int i = tid * PER; i < V.R.blk; i += NT * PER) cp_async16(slot + i, blk + i);
  const int nm = C * BS, nP = C * BS * BS;
  const T* P0 = va.Pinf;
  if (u > 0) {
    const T* m0 = va.ms + (size_t)(u - 1) * nm;
    P0 = va.Ps + (size_t)(u - 1) * nP;
    for (int i = tid; i < nm; i += NT) cp_async_small<E>(slot + V.m0 + i, m0 + i);
  } else {
    for (int i = tid; i < nm; i += NT) slot[V.m0 + i] = T(0);
  }
  for (int i = tid; i < nP; i += NT) cp_async_small<E>(slot + V.P0 + i, P0 + i);
  if (va.g_tt)
    for (int i = tid; i < C; i += NT) cp_async_small<E>(slot + V.gtt + i, va.g_tt + (size_t)u * C + i);
  if (va.g_tn)
    for (int i = tid; i < C; i += NT) cp_async_small<E>(slot + V.gtn + i, va.g_tn + (size_t)u * C + i);
  if (va.g_lZ && tid == 0) cp_async_small<E>(slot + V.glZ, va.g_lZ + u);
}

// Sum v[0 .. 2H) with lane ^ o (o a power of two at or above the group
// width, uniform): the lane keeps the half its bit o picks, in v[0 .. H).
template <int H, typename T, int NV>
__device__ __forceinline__ void halve(T (&v)[NV], int lane, int o) {
  const bool hi = (lane & o) != 0;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const T send = hi ? v[i] : v[i + H];
    const T keep = hi ? v[i + H] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
  }
}

// A warp's lanes' sums merged by recursive halving over its groups, into
// the warp's record pr[g_lane * NV + i] (every slot written once).
template <typename T, int NV>
__device__ __forceinline__ void vjp_merge_lanes(T (&v)[NV], int lane, int g_lane, int G, T* pr) {
  static_assert(NV == 16, "the halving below is written for 16 sums a lane");
  int base = 0, kept = 16;
  if (G <= 16) { halve<8>(v, lane, 16); base += lane & 16 ? 8 : 0; kept = 8; }
  if (G <= 8) { halve<4>(v, lane, 8); base += lane & 8 ? 4 : 0; kept = 4; }
  if (G <= 4) { halve<2>(v, lane, 4); base += lane & 4 ? 2 : 0; kept = 2; }
  if (G <= 2) { halve<1>(v, lane, 2); base += lane & 2 ? 1 : 0; kept = 1; }
  if (G <= 1) v[0] += __shfl_xor_sync(0xffffffffu, v[0], 1);
  if (G > 1 || (lane & 1) == 0) {
#pragma unroll
    for (int i = 0; i < NV; ++i)
      if (i < kept) pr[g_lane * NV + base + i] = v[i];
  }
}

// A points lane of the stashed walk (warps 1 .. nwp, one round): its PB
// points, fixed for the walk.
template <typename T, int PB>
struct VjpPoints {
  static constexpr int DB = ADF_DB;
  int s[PB];    // the point, S if none
  T x[PB][DB];  // the lane's modulators' unit points, zero beyond N

  __device__ __forceinline__ void init(const AdfStep<T, PB>& st) {
    const int q = ((st.w - 1) * st.L.GW + st.grp) * PB, N = st.N;
    const T* xi = st.L.staged ? st.xi_sh : st.xi;  // round 0 is stored in point order
#pragma unroll
    for (int p = 0; p < PB; ++p) {
      s[p] = q + p < st.S ? q + p : st.S;
#pragma unroll
      for (int j = 0; j < DB; ++j) {
        const int n = st.d0 + j;
        x[p][j] = s[p] < st.S && n < N ? xi[(size_t)s[p] * N + n] : T(0);
      }
    }
  }
};

// What such a lane reads of its points from the ring a step (before barrier
// A), and the amplitudes' cotangents it forms.
template <typename T, int PB>
struct VjpLane {
  static constexpr int DB = ADF_DB, NV = 4 * DB;
  T a[PB][DB];    // amplitudes, after 'sq'
  T h[PB][DB];    // 'sq': 0.5 / a where the floor does not bind, else 0
  T sc[PB][4];    // weight, rs, 1 / s2e, rs^2 - 1 / s2e
  T dlk[PB][DB];  // the link's derivative at the lane's modulators
  T ga[PB][DB];   // the amplitudes' cotangents on the raw scale (W's, after barrier B)

  __device__ __forceinline__ void load(const AdfStep<T, PB>& st, const VjpPoints<T, PB>& pt,
                                       const VjpRecord& R, const T* blk) {
    const int* s = pt.s;
    const int d0 = st.d0;
    const bool owns = d0 < st.N;  // modulators d0 .. d0 + DB - 1 (zero beyond N)
#pragma unroll
    for (int p = 0; p < PB; ++p) {
      const bool ok = s[p] < st.S;
      const int sp = ok ? s[p] : 0;
      const Pack<T, DB> av = *reinterpret_cast<const Pack<T, DB>*>(blk + R.a + sp * R.Dp + d0);
      const Pack<T, DB> hv = *reinterpret_cast<const Pack<T, DB>*>(blk + R.h + sp * R.Dp + d0);
      const Pack<T, 4> sv = *reinterpret_cast<const Pack<T, 4>*>(blk + R.sc + 4 * sp);
      Pack<T, DB> dv;
#pragma unroll
      for (int j = 0; j < DB; ++j) dv.v[j] = T(0);
      if (owns) dv = *reinterpret_cast<const Pack<T, DB>*>(blk + R.dlk + sp * R.Np + d0);
#pragma unroll
      for (int j = 0; j < DB; ++j) {
        a[p][j] = ok ? av.v[j] : T(0);
        h[p][j] = ok ? hv.v[j] : T(0);
        dlk[p][j] = ok && d0 + j < st.N ? dv.v[j] : T(0);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) sc[p][k] = ok ? sv.v[k] : T(0);
    }
  }

  // The cotangent half of match_vjp for these points: gZ and the totals'
  // cotangents g4 to this lane's sums acc of mu_z, s2_z, mu_g and sd.
  __device__ __forceinline__ void cotangents(const AdfStep<T, PB>& st, const VjpPoints<T, PB>& pt,
                                             T gZ, const T* g4, double& gsn2, T (&acc)[NV]) {
    const int Dp = st.L.Dp, d0 = st.d0, N = st.N, G = st.L.G;
    const int* s = pt.s;
    const T(&x)[PB][DB] = pt.x;
#pragma unroll
    for (int i = 0; i < NV; ++i) acc[i] = T(0);
    const Pack<T, DB> gA1 = *reinterpret_cast<const Pack<T, DB>*>(g4 + d0);
    const Pack<T, DB> gA2 = *reinterpret_cast<const Pack<T, DB>*>(g4 + Dp + d0);
    const Pack<T, DB> gX1 = *reinterpret_cast<const Pack<T, DB>*>(g4 + 2 * Dp + d0);
    const Pack<T, DB> gX2 = *reinterpret_cast<const Pack<T, DB>*>(g4 + 3 * Dp + d0);
    const Pack<T, DB> hz = *reinterpret_cast<const Pack<T, DB>*>(st.hph_z + d0);
    const Pack<T, DB> mz = *reinterpret_cast<const Pack<T, DB>*>(st.fmu_z + d0);
    T u[3][PB];
#pragma unroll
    for (int p = 0; p < PB; ++p) {
      u[0][p] = u[1][p] = u[2][p] = T(0);
#pragma unroll
      for (int j = 0; j < DB; ++j) {
        u[0][p] += gA1.v[j] * a[p][j];
        u[1][p] += gA2.v[j] * (a[p][j] * a[p][j]);
        u[2][p] += gX1.v[j] * x[p][j] + gX2.v[j] * (x[p][j] * x[p][j]);
      }
    }
#pragma unroll
    for (int off = 1; off < 32; off <<= 1)  // straight-line: uniform guards, no loop
      if (off < G) {
#pragma unroll
        for (int p = 0; p < PB; ++p)
#pragma unroll
          for (int k = 0; k < 3; ++k) u[k][p] += __shfl_xor_sync(0xffffffffu, u[k][p], off);
      }
#pragma unroll
    for (int p = 0; p < PB; ++p) {
      const T wns = sc[p][0], rs = sc[p][1], inv = sc[p][2], c2 = sc[p][3];
      const T g_wns = gZ + rs * u[0][p] + c2 * u[1][p] + u[2][p];
      const T g_rs = wns * (u[0][p] + T(2) * rs * u[1][p]);
      const T g_inv = -wns * u[1][p];
      const T g_ln = g_wns * wns;
      const T g_resid = g_rs * inv - g_ln * rs;
      const T g_s2e = T(0.5) * g_ln * c2 - g_rs * rs * inv - g_inv * inv * inv;
      if (st.g_lane == 0 && s[p] < st.S) gsn2 += (double)g_s2e;
      const T wr = wns * rs, wc = T(2) * wns * c2;
#pragma unroll
      for (int j = 0; j < DB; ++j) {
        const T aj = a[p][j];
        const T g = wr * gA1.v[j] + wc * gA2.v[j] * aj - g_resid * mz.v[j] +
                    T(2) * g_s2e * aj * hz.v[j];
        acc[j] -= g_resid * aj;
        acc[DB + j] += g_s2e * (aj * aj);
        ga[p][j] = st.sq ? g * h[p][j] : g;
      }
    }
    // the link values' cotangents, summed over the group; the lane that owns
    // modulator n takes its mean's and sd's (unrolled, so that the modulators'
    // butterflies overlap)
#pragma unroll 4
    for (int n = 0; n < N; ++n) {
      const Pack<T, DB> wv = *reinterpret_cast<const Pack<T, DB>*>(st.Wt + n * Dp + d0);
      T gl[PB];
#pragma unroll
      for (int p = 0; p < PB; ++p) {
        gl[p] = T(0);
#pragma unroll
        for (int j = 0; j < DB; ++j) gl[p] += ga[p][j] * wv.v[j];
      }
#pragma unroll
      for (int off = 1; off < 32; off <<= 1)
        if (off < G) {
#pragma unroll
          for (int p = 0; p < PB; ++p) gl[p] += __shfl_xor_sync(0xffffffffu, gl[p], off);
        }
#pragma unroll
      for (int j = 0; j < DB; ++j)
        if (n == d0 + j) {
#pragma unroll
          for (int p = 0; p < PB; ++p) {
            const T gx = gl[p] * dlk[p][j];
            acc[2 * DB + j] += gx;
            acc[3 * DB + j] += gx * x[p][j];
          }
        }
    }
  }

  // W's cotangent, this lane's subbands (float64), after barrier B.
  __device__ __forceinline__ void add_w(const AdfStep<T, PB>& st, const VjpPoints<T, PB>& pt,
                                        const VjpRecord& R, const T* blk, double* wacc) const {
    const int* s = pt.s;
    for (int n0 = 0; n0 < st.N; n0 += 4) {
      Pack<T, 4> lk[PB];
#pragma unroll
      for (int p = 0; p < PB; ++p) {
        lk[p] = *reinterpret_cast<const Pack<T, 4>*>(blk + R.lk + (s[p] < st.S ? s[p] : 0) * R.Np + n0);
        if (!(s[p] < st.S))
#pragma unroll
          for (int k = 0; k < 4; ++k) lk[p].v[k] = T(0);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int n = n0 + k;
        if (n < st.N) {
          double* w = wacc + (size_t)n * DB * ADF_THREADS + st.tid;
          double old[DB];
#pragma unroll
          for (int j = 0; j < DB; ++j) old[j] = w[j * ADF_THREADS];
#pragma unroll
          for (int j = 0; j < DB; ++j) {
            double sum = 0.0;
#pragma unroll
            for (int p = 0; p < PB; ++p) sum += (double)(ga[p][j] * lk[p].v[k]);
            if (st.d0 + j < st.D) w[j * ADF_THREADS] = old[j] + sum;
          }
        }
      }
    }
  }
};

// Channel c's prediction of step t in the walk: from the record where it
// holds one, else again from the ring's (m0, P0) and the staged model mdl.
// Null outputs are not wanted (part 1 wants PH alone).
template <typename T, int BS>
__device__ __forceinline__ void vjp_prediction(const VjpLayout& V, const T* slot, const T* cr, int c,
                                               const T* mdl, T (*m0)[BS], T (*P0)[BS][BS],
                                               T (*mp)[BS], T (*AP)[BS][BS], T (*Pp)[BS][BS],
                                               T (&PH)[BS]) {
  constexpr int BB = BS * BS;
  const VjpRecord& R = V.R;
  T m0_[BS], P0_[BS][BS];
  if (m0 || !R.pred) {
#pragma unroll
    for (int i = 0; i < BS; ++i) m0_[i] = slot[V.m0 + c * BS + i];
    load_mat<T, BS>(P0_, slot + V.P0 + c * BB);
  }
  if (m0) {
#pragma unroll
    for (int i = 0; i < BS; ++i) (*m0)[i] = m0_[i];
#pragma unroll
    for (int i = 0; i < BS; ++i)
#pragma unroll
      for (int j = 0; j < BS; ++j) (*P0)[i][j] = P0_[i][j];
  }
  if (R.pred) {
    const T* pr = cr + VJP_CW;
    load_vec<T, BS>(PH, pr + R.bsp);
    if (mp) {
      load_vec<T, BS>(*mp, pr);
      load_mat_vec<T, BS>(*AP, pr + 2 * R.bsp);
      load_mat_vec<T, BS>(*Pp, pr + 2 * R.bsp + R.bbp);
    }
    return;
  }
  T A[BS][BS], Q[BS][BS], H[BS], mp_[BS], AP_[BS][BS], Pp_[BS][BS], fmu, var;
  load_mat_vec<T, BS>(A, mdl);
  load_mat_vec<T, BS>(Q, mdl + R.bbp);
  load_vec<T, BS>(H, mdl + 2 * R.bbp);
  predict<T, BS>(A, Q, m0_, P0_, mp_, AP_, Pp_);
  observe<T, BS>(H, mp_, Pp_, fmu, PH, var);
  if (mp) {
#pragma unroll
    for (int i = 0; i < BS; ++i) (*mp)[i] = mp_[i];
#pragma unroll
    for (int i = 0; i < BS; ++i)
#pragma unroll
      for (int j = 0; j < BS; ++j) {
        (*AP)[i][j] = AP_[i][j];
        (*Pp)[i][j] = Pp_[i][j];
      }
  }
}

// Channel c's cotangents of A, Q, H at one step (gp, NP values) into its
// float64 sums, a stride of C.
template <int NP, typename T>
__device__ __forceinline__ void vjp_add_params(double* psum, int C, int c, const T* gp) {
  double* ps = psum + c;
  double old[NP];
#pragma unroll
  for (int k = 0; k < NP; ++k) old[k] = ps[(size_t)k * C];
#pragma unroll
  for (int k = 0; k < NP; ++k) ps[(size_t)k * C] = old[k] + (double)gp[k];
}

template <typename T, int BS>
__device__ __forceinline__ void vjp_walk(const AdfCore<T>& core, const VjpArgs<T>& va) {
  constexpr int NT = ADF_THREADS, PB = ADF_PB_ONE, DB = ADF_DB, BB = BS * BS, NV = 4 * DB;
  constexpr int NPAR = 2 * BB + BS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sh = reinterpret_cast<T*>(smem_raw);
  const AdfStep<T, PB> st(core, 0, 1, sh);
  const int D = core.D, N = core.N, C = D + N, Dp = st.L.Dp, n_steps = core.n_steps;
  const VjpLayout V = vjp_layout(D, N, core.S, BS, sizeof(T), va.stash);
  const VjpRecord& R = V.R;
  const int tid = st.tid, c = tid, own = st.own;
  const bool chan = st.chan, mod = tid >= D, stash = va.stash != 0;
  // the stashed walk's point warps: 1 .. nwp, a round of GW * PB points each;
  // the warps after them (else warps 1 .. NW-1) fetch the ring
  const int nwp = (core.S + st.L.GW * PB - 1) / (st.L.GW * PB);
  const bool points = stash && st.w > 0 && st.w <= nwp;
  const int fetch0 = stash && nwp < ADF_NW - 1 ? (nwp + 1) * 32 : 32;
  T* g4 = sh + V.g4;
  T* zi = sh + V.zi;
  T* zd = sh + V.zd;
  T* lkbar_w = sh + V.lkbar + st.w * N * st.L.PT;
  T* ring = sh + V.ring;
  const T* mdl = sh + V.mdl + c * V.mw;  // channel c's A, Q, H
  T* pend = sh + V.pend + c * NPAR;      // channel c's cotangents of A, Q, H not yet summed
  double* sn2_part = reinterpret_cast<double*>(smem_raw + V.dbl);
  double* psum = V.sums_shared ? sn2_part + NT : va.scratch;  // [npar][C]: A, Q, H
  double* wacc = psum + (size_t)C * V.npar;                  // [N][DB][NT]
  for (int i = tid; i < C * V.npar + V.nw; i += NT) psum[i] = 0.0;
  for (int i = tid; i < 4 * Dp; i += NT) g4[i] = T(0);
  for (int i = tid; i < VJP_NSTAGE * V.slot; i += NT) ring[i] = T(0);
  for (int i = tid; i < C * V.mw; i += NT) {
    const int ch = i / V.mw, k = i - ch * V.mw;
    T v = T(0);
    if (k < BB)
      v = va.A[(size_t)ch * BB + k];
    else if (k >= R.bbp && k < R.bbp + BB)
      v = va.Q[(size_t)ch * BB + k - R.bbp];
    else if (k >= 2 * R.bbp && k < 2 * R.bbp + BS)
      v = va.H[(size_t)ch * BS + k - 2 * R.bbp];
    sh[V.mdl + i] = v;
  }
  const T damp = core.damp;
  T m_bar[BS], P_bar[BS][BS];  // cotangents of step t's filtered state
#pragma unroll
  for (int i = 0; i < BS; ++i) {
    m_bar[i] = T(0);
#pragma unroll
    for (int j = 0; j < BS; ++j) P_bar[i][j] = T(0);
  }
  double gsn2 = 0.0;
  bool pending = false;  // pend holds a step's cotangents of A, Q, H
  VjpPoints<T, PB> pts;
  if (points) pts.init(st);
  AdfProbe pc(tid == 0 && core.cyc != nullptr), pp(tid == 32 && core.cyc != nullptr);
  int n_seen = 0;
  __syncthreads();
  for (int u = n_steps - 1; u >= 0 && u >= n_steps - 2; --u)
    vjp_fetch<T, BS>(va, V, C, u, ring + (u % VJP_NSTAGE) * V.slot, tid, NT);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  for (int t = n_steps - 1; t >= 0; --t) {
    const T* slot = ring + (t % VJP_NSTAGE) * V.slot;
    const T* cr = slot + VJP_HDR + c * R.cw;  // channel c's part of the record
    const bool observed = slot[VH_OBS] != T(0);  // uniform over the CTA
    n_seen += observed;
    VjpLane<T, PB> vl;  // a points lane's values, this step only

    // ---- 1. the update, the site and log Z backwards (the channel threads,
    //         warp 0); the points' forward values (warps 1 .. nwp) --------
    T var = T(0), g_fmu = T(0), g_var = T(0), g_sd = T(0), g_PH[BS];
    T zi_c = T(0), zd_c = T(0);  // this channel's share of Zi's and Z's cotangents
    if (chan) {
      T PH[BS], s0[4], s1[4], s2[4], s3[4], s4[4];
      vjp_prediction<T, BS>(V, slot, cr, c, mdl, nullptr, nullptr, nullptr, nullptr, nullptr, PH);
      load_vec<T, 4>(s0, cr);
      load_vec<T, 4>(s1, cr + 4);
      load_vec<T, 4>(s2, cr + 8);
      load_vec<T, 4>(s3, cr + 12);
      load_vec<T, 4>(s4, cr + 16);
      const T fmu = s0[VC_FMU], sd = s0[VC_SD], tt = s0[VC_TT], tn = s1[VC_TN - 4];
      var = s0[VC_VAR];
      if (observed) {
        T sd_pub;
        st.publish(fmu, var, sd_pub);
      }
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
      pc.mark(0);
      // m = mp - PH v, P = Pp - w PH PH' backwards (m_bar, P_bar become the
      // prediction's cotangents)
      const T iz = s3[VC_IZ - 12], v = s4[VC_V - 16], w = s4[VC_W - 16];
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
      const T g_z = -(g_v * v + g_w * w) * iz;
      g_fmu = g_v * tt * iz;
      g_var = g_z * tt;
      if (observed) {
        const T r = s1[VC_R - 4], iden = s1[VC_IDEN - 4], d2 = s1[VC_D2 - 4];
        const T dl = s2[VC_DL - 8], S1 = s2[VC_S1 - 8], S2 = s2[VC_S2 - 8], Zi = slot[VH_ZI];
        const T g_tt = slot[V.gtt + c] + (g_v * fmu + g_w) * iz + g_z * var;
        const T g_tn = slot[V.gtn + c] - g_v * iz;
        // tt = max(damp r, 0), r = -d2 / denom, tn = damp (dl - fmu d2) / denom
        const T g_r = damp * r >= T(0) ? damp * g_tt : T(0);
        const T g_den = -(g_tn * tn + g_r * r) * iden;
        T g_dl = damp * g_tn * iden;
        const T g_d2 = -damp * g_tn * fmu * iden - g_r * iden + g_den * var;
        g_fmu -= damp * g_tn * d2 * iden;
        g_var += g_den * d2;
        // dl = Zi S1, d2 = Zi S2 - dl^2
        g_dl -= T(2) * dl * g_d2;
        const T g_S1 = g_dl * Zi, g_S2 = g_d2 * Zi;
        zi_c = g_d2 * S2 + g_dl * S1;
        if (mod) {  // S1 = rg X1, S2 = rg^2 X2 - Z / var, rg = sd / var
          const T X1 = s2[VC_X1 - 8], X2 = s3[VC_X2 - 12], rg = s3[VC_RG - 12];
          const T is2 = s3[VC_IS2 - 12];
          const T g_rg = g_S1 * X1 + T(2) * rg * g_S2 * X2;
          const T g_is2 = g_rg * sd - g_S2 * slot[VH_Z];
          g_sd = g_rg * is2;
          g_var -= g_is2 * is2 * is2;
          zd_c = -is2 * g_S2;
          g4[2 * Dp + own] = g_S1 * rg;
          g4[3 * Dp + own] = g_S2 * (rg * rg);
        } else {
          g4[own] = g_S1;
          g4[Dp + own] = g_S2;
        }
      }
      pc.mark(1);
    } else if (points && observed) {
      vl.load(st, pts, R, slot);  // the points' forward values, while warp 0 works
      pp.mark(0);
    }
    if (observed && st.w * 32 < C) {  // the channels' shares, summed a warp
      for (int off = 16; off > 0; off >>= 1) {
        zi_c += __shfl_xor_sync(0xffffffffu, zi_c, off);
        zd_c += __shfl_xor_sync(0xffffffffu, zd_c, off);
      }
      if (st.lane == 0) {
        zi[st.w] = zi_c;
        zd[st.w] = zd_c;
      }
    }

    __syncthreads();  // ---- A: the totals' cotangents are published ---------
    pc.mark(2);
    pp.mark(1);

    // ---- 2, 3 backwards: Z's cotangent, then the sigma points --------------
    if (observed) {
      T g_mu = T(0), g_s = T(0);
      if (!stash || points) {
        T g_Zi = T(0), g_Zd = T(0);
        for (int i = 0; i * 32 < C; ++i) {
          g_Zi += zi[i];
          g_Zd += zd[i];
        }
        // Zi = exp(lZ_raw - lZk) / Z0, lZk = max(lZ_raw, log_floor),
        // lZ_raw = shift + log Z0, Z0 = max(Z, tiny)
        const T iZ0 = slot[VH_IZ0], e = slot[VH_E], Zi = slot[VH_ZI];
        const T g_e = g_Zi * iZ0;
        const T g_lZk = slot[V.glZ] - g_e * e;
        const T g_raw = g_e * e + (slot[VH_FLOOR] != T(0) ? g_lZk : T(0));
        const T g_Z0 = -g_Zi * Zi * iZ0 + g_raw * iZ0;
        const T gZ = (slot[VH_TINY] != T(0) ? g_Z0 : T(0)) + g_Zd;
        pp.mark(2);
        if (stash) {
          T acc[NV];
          vl.cotangents(st, pts, gZ, g4, gsn2, acc);
          pp.mark(3);
          vjp_merge_lanes<T, NV>(acc, st.lane, st.g_lane, st.L.G, st.part + st.w * st.L.rec);
        } else {
          cp_async_wait<0>();  // step t-1 in the ring before match_vjp's barrier (B)
          st.match_vjp(slot[VH_Y], slot[VH_MALL], gZ, g4, lkbar_w, wacc, gsn2, g_mu, g_s);
        }
      }
      if (stash) {
        if (chan && pending) vjp_add_params<NPAR>(psum, C, c, pend);  // where warp 0 waits
        cp_async_wait<0>();
        __syncthreads();  // ---- B: the lanes' sums are in the warps' records
        pc.mark(3);
        if (chan) {
          const int base = (own / DB) * NV + (tid < D ? 0 : 2 * DB) + own % DB;
          T mu_w[ADF_NW], s_w[ADF_NW];
#pragma unroll
          for (int p = 1; p < ADF_NW; ++p) {
            mu_w[p] = p <= nwp ? st.part[p * st.L.rec + base] : T(0);
            s_w[p] = p <= nwp ? st.part[p * st.L.rec + base + DB] : T(0);
          }
#pragma unroll
          for (int p = 1; p < ADF_NW; ++p) {
            g_mu += mu_w[p];
            g_s += s_w[p];
          }
        }
      }
      if (chan) {
        g_fmu += g_mu;
        if (mod) {
          g_sd += g_s;  // sd = sqrt(max(var, 0))
          g_var += var >= T(0) ? T(0.5) * g_sd * cr[VC_ISD] : T(0);
        } else {
          g_var += g_s;
        }
      }
    } else {
      if (chan && pending) vjp_add_params<NPAR>(psum, C, c, pend);
      cp_async_wait<0>();
      __syncthreads();  // ---- B
    }
    pending = false;
    pc.mark(stash ? 7 : 3);
    pp.mark(4);
    // step t-2 into the slot step t+1 used, by the warps after the points
    // (else warps 1 .. NW-1), while warp 0 runs the prediction backwards;
    // complete before the next barrier B
    if (tid >= fetch0 && t >= 2)
      vjp_fetch<T, BS>(va, V, C, t - 2, ring + ((t - 2) % VJP_NSTAGE) * V.slot, tid - fetch0,
                       NT - fetch0);
    cp_async_commit();

    // ---- 1 backwards: the observation and the prediction (warp 0); W's
    //      cotangent (the points' lanes) ---------------------------------
    if (chan) {
      T A[BS][BS], H[BS], m0[BS], P0[BS][BS], mp[BS], AP[BS][BS], Pp[BS][BS], PH[BS];
      load_mat_vec<T, BS>(A, mdl);
      load_vec<T, BS>(H, mdl + 2 * R.bbp);
      vjp_prediction<T, BS>(V, slot, cr, c, mdl, &m0, &P0, &mp, &AP, &Pp, PH);
      pc.mark(4);
      // fmu = H mp, PH = Pp H, var = H' PH
      T g_mp[BS], g_Pp[BS][BS], gp[NPAR];  // this step's cotangents of A, Q, H
#pragma unroll
      for (int i = 0; i < BS; ++i) g_PH[i] += g_var * H[i];
#pragma unroll
      for (int j = 0; j < BS; ++j) {
        T s = g_var * PH[j] + g_fmu * mp[j];
#pragma unroll
        for (int i = 0; i < BS; ++i) s += g_PH[i] * Pp[i][j];
        gp[2 * BB + j] = s;
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
#pragma unroll
      for (int i = 0; i < BS; ++i)
#pragma unroll
        for (int j = 0; j < BS; ++j) {
          T s = g_mp[i] * m0[j];
#pragma unroll
          for (int k = 0; k < BS; ++k) s += g_Pp[k][i] * AP[k][j] + g_AP[i][k] * P0[j][k];
          gp[i * BS + j] = s;
          gp[BB + i * BS + j] = g_Pp[i][j];
        }
      pc.mark(5);
      if (stash) {  // summed between the next step's barriers
#pragma unroll
        for (int k = 0; k < NPAR; ++k) pend[k] = gp[k];
        pending = true;
      } else {
        vjp_add_params<NPAR>(psum, C, c, gp);
      }
      pc.mark(6);
    } else if (points && observed) {
      vl.add_w(st, pts, R, slot, wacc);
      pp.mark(5);
    }
  }

  // ---- the end: Pinf's cotangent is P_bar at step 0; the float64 sums -----
  pc.write(core.cyc, n_seen);
  pp.write(core.cyc + ADF_PROBE_PHASES + 1, n_seen);
  if (chan && pending) vjp_add_params<NPAR>(psum, C, c, pend);
  cp_async_wait<0>();
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

// K7's two parts: PART = VJP_PREPASS, a grid over the steps that writes the
// record; PART = VJP_WALK, one CTA that walks the steps backwards.
template <typename T, int BS, int PART>
__global__ void __launch_bounds__(ADF_THREADS, 1)
fused_adf_vjp_kernel(AdfCore<T> core, VjpArgs<T> va) {
  if constexpr (PART == VJP_PREPASS)
    vjp_prepass<T, BS>(core, va);
  else
    vjp_walk<T, BS>(core, va);
}

// K7's probe: thread 0's and thread 32's slots, each followed by the
// observed steps.
constexpr int VJP_PROBE_SLOTS = 2 * (ADF_PROBE_PHASES + 1);

template <typename T, int BS>
int launch_adf_vjp(const void* y, const void* obs, const void* A, const void* Q,
                   const void* Pinf, const void* H, const void* W, const void* xi,
                   const void* wn, const void* sn2, const void* ms, const void* Ps,
                   const void* g_ms, const void* g_Ps, const void* g_lZ, const void* g_tt,
                   const void* g_tn, double damp, double log_floor, int n_steps, int D, int N,
                   int S, int link_exp, int sq, void* gA, void* gQ, void* gPinf, void* gH,
                   void* gW, void* gsn2, void* scratch, void* rec, int stash, void* cyc,
                   cudaStream_t st) {
  if (n_steps < 1 || D < 1 || N < 1 || S < 1 || D > ADF_MAX_WIDTH || N > ADF_MAX_WIDTH ||
      D + N > ADF_THREADS || rec == nullptr)
    return -2;
  const VjpLayout V = vjp_layout(D, N, S, BS, sizeof(T), stash);
  if (V.bytes > ADF_SMEM_MAX || (stash && !vjp_can_stash(D, N, S, BS, sizeof(T)))) return -2;
  void (*pre)(AdfCore<T>, VjpArgs<T>) = fused_adf_vjp_kernel<T, BS, VJP_PREPASS>;
  void (*walk)(AdfCore<T>, VjpArgs<T>) = fused_adf_vjp_kernel<T, BS, VJP_WALK>;
  const size_t pre_bytes = (size_t)V.mdl * sizeof(T);
  cudaError_t e = cudaSuccess;
  if (pre_bytes > 48 * 1024)
    e = cudaFuncSetAttribute(pre, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pre_bytes);
  if (e == cudaSuccess && V.bytes > 48 * 1024)
    e = cudaFuncSetAttribute(walk, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)V.bytes);
  int dev = 0, sms = 1, per_sm = 1;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pre, ADF_THREADS, pre_bytes);
  if (e != cudaSuccess) return (int)e;
  const int cap = sms * (per_sm > 0 ? per_sm : 1), grid = n_steps < cap ? n_steps : cap;
  const AdfCore<T> core = adf_core<T>(y, obs, W, xi, wn, sn2, damp, log_floor, ADF_SQ_FLOOR,
                                      n_steps, /*BF=*/1, D, N, S, link_exp, sq, cyc);
  const VjpArgs<T> va{(const T*)A,    (const T*)Q,    (const T*)Pinf, (const T*)H,
                      (const T*)ms,   (const T*)Ps,   (const T*)g_ms, (const T*)g_Ps,
                      (const T*)g_lZ, (const T*)g_tt, (const T*)g_tn, (T*)gA,
                      (T*)gQ,         (T*)gPinf,      (T*)gH,         (T*)gW,
                      (T*)gsn2,       (double*)scratch, (T*)rec,      stash};
  pre<<<grid, ADF_THREADS, pre_bytes, st>>>(core, va);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  walk<<<1, ADF_THREADS, V.bytes, st>>>(core, va);
  return (int)cudaGetLastError();
}

}  // namespace

// The C entry point of one dtype: nsgp_fused_adf_vjp_<SUFFIX>.  `scratch`
// holds nsgp_adf_vjp_scratch(D, N, bs) float64 values, `rec` T x
// nsgp_adf_vjp_record(D, N, S, bs, sizeof(T), stash) values.
#define NSGP_DEFINE_FUSED_ADF_VJP(SUFFIX, T)                                                    \
  extern "C" int nsgp_fused_adf_vjp_##SUFFIX(                                                   \
      int bs, const void* y, const void* obs, const void* A, const void* Q, const void* Pinf,   \
      const void* H, const void* W, const void* xi, const void* wn, const void* sn2,            \
      const void* ms, const void* Ps, const void* g_ms, const void* g_Ps, const void* g_lZ,     \
      const void* g_tt, const void* g_tn, double damp, double log_floor, int n_steps, int D,    \
      int N, int S, int link_exp, int sq, void* gA, void* gQ, void* gPinf, void* gH, void* gW,  \
      void* gsn2, void* scratch, void* rec, int stash, void* cyc, void* stream) {               \
    cudaStream_t st = (cudaStream_t)stream;                                                     \
    NSGP_DISPATCH_BS(launch_adf_vjp, T, y, obs, A, Q, Pinf, H, W, xi, wn, sn2, ms, Ps, g_ms,    \
                     g_Ps, g_lZ, g_tt, g_tn, damp, log_floor, n_steps, D, N, S, link_exp, sq,   \
                     gA, gQ, gPinf, gH, gW, gsn2, scratch, rec, stash, cyc, st)                 \
  }
