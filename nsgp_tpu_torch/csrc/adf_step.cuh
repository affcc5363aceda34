// The ADF forward sweep shared by K3 (fused_adf.cuh, one signal), K4
// (fused_adf_mb.cuh, BF files) and K5 (fused_ihgp_adf.cuh, IHGP's steady
// sweep): one device function, adf_sweep, that all three kernels call.  It
// does the moment match of a step (phases 2 and 3 below) and leaves what it
// carries between steps to a recursion policy (phases 1 and 4): K3 and K4
// carry the covariance filter (CovRecursion, here), K5 a steady-state table
// lookup (SteadyRecursion).  K3 is the BF = 1 instantiation of K4's code.
//
// What bounds it.  The sweep is a T-long recursion; per observed step it
// evaluates S sigma points (S * D * N multiply-adds, S * N link values, one
// log and one exp a point) and reduces them to K = 1 + 2D + 2N totals
// (Z, A1[D], A2[D], G1[N], G2[N]) before the next step can start.  Bytes and
// operations are two to four orders below the card's rates: what counts is
// the latency of one step, that is instructions per sigma point, barriers per
// step, and how many SMs share the points.
//
// What the design does about it.
//
// * Register tiles.  A sigma point is owned by a group of G lanes of one
//   warp (G a power of two with G * DB >= D and G * DB >= N, so G = 4 at
//   D = 16 and 16 at D = 48); a lane holds DB = 4 subbands of PB points
//   (PB = 2 with one CTA a file, 4 in a cluster, where there are points
//   enough to fill the lanes): a[PB][DB] in registers, W read as one 16-byte
//   load a modulator (stored transposed and padded, W_t[n][d]), the link
//   values of the PB points as one load a modulator.  s2e and the mean are
//   finished by a butterfly over the G lanes.  No array is sized by the
//   runtime D or N.
// * Link values once a point.  The lanes of a warp first share out the
//   PT * N link evaluations of the warp's PT = (32 / G) * PB points and
//   leave them in the warp's own stash in shared memory (__syncwarp only).
// * Scalars once a point.  Lane p of a group computes point p's s2e,
//   residual, log-normaliser and weights and hands them round by shuffles
//   (when G >= PB; narrower models let every lane do all PB).
// * No terms buffer, no block max, no barrier per tile.  Each lane keeps its
//   share of the totals in 17 registers (Z, A1 and A2 of its DB subbands,
//   and for its DB modulators the weighted first and second moments of the
//   unit point, from which sd / s2_g and 1 / s2_g factor out: the channel
//   thread scales them to G1 and G2) under its own running shift: a round
//   whose largest log-normaliser exceeds the shift rescales the lane's
//   totals, and every point is added at weight exp(ln - shift).  Once per
//   step the partials are merged in a fixed order: the warp's shift, one
//   rescale and butterfly sums over the groups of a warp, then the warps'
//   records in shared memory, then (cluster) the CTAs' records.  A partial
//   with no point has shift -inf and merges at weight zero.  The "not finite
//   -> 0" rule is applied to the merged shift once.  No atomics: two runs
//   give the same bits.  Both s_chunk modes of the wrapper run this one
//   code; a point is evaluated once in either.
// * 256 threads (8 warps); the shared layout is a few KB plus the staged
//   sigma points, whatever D and N.
// * Hoisted: 1 / s2_g and sd / s2_g once per step and modulator, 1 / s2e once
//   per point; the CTA's own xi and wn rows are staged in shared memory once
//   per launch (in the order the warps walk them) when they fit, else read
//   from global memory through the same pointer (one code path: a branch per
//   load kept the compiler from batching them and doubled the phase).
// * 'sq' amplitudes take sqrt_pos (rsqrt and a Newton step, no special-case
//   branch) in float32: the argument is clamped to >= 1e-12.
// * A thread-block cluster over the sigma points.  R = min(8, ceil(S / 512))
//   CTAs work on one file (R = 1 at S = 77 and 193, 8 at S = 3973); rank r
//   takes every R-th round of points.  Every CTA runs the channel recursion
//   redundantly on identical inputs; per observed step each publishes its
//   merged record in its own shared memory (double-buffered by the count of
//   observed steps), one cluster.sync(), and every channel thread reads the R
//   records through distributed shared memory in rank order, so all copies
//   of the recursion stay bit-identical.  Rank 0 stores the outputs.  The
//   observed flag is uniform over the cluster (all ranks read the same y and
//   obs), so every CTA reaches every barrier; a last cluster.sync() keeps a
//   CTA's shared memory alive until no other can read it.
//
// Kept: no --use_fast_math, a clamp_min that propagates NaN, the raw-scale Z
// floor, steps that are not matched skip the cubature (their lZ = 0; K3 and
// K4 take zero sites there), padded state dims inert.
//
// With -DNSGP_CLOCK_PROBE thread 0 of CTA 0 adds up clock64() per phase and
// writes the sums to `cyc` (tools/probe_adf_cycles.py); the shipped library
// is built without it and ignores `cyc`.

#pragma once

#include <cooperative_groups.h>

#include "nsgp_common.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int ADF_THREADS = 256;
constexpr int ADF_NW = ADF_THREADS / 32;
constexpr int ADF_PB_ONE = 2;                // sigma points a lane, one CTA a file
constexpr int ADF_PB_CLUSTER = 4;            // ... in a cluster (many points: more per lane)
constexpr int ADF_DB = 4;                    // subbands (and modulators) a lane
constexpr int ADF_NACC = 1 + 4 * ADF_DB;     // Z, A1, A2, G1, G2 of one lane
constexpr int ADF_MAX_WIDTH = 32 * ADF_DB;   // most subbands, most modulators
constexpr int ADF_MAX_CLUSTER = 8;           // the portable cluster size
constexpr int ADF_POINTS_PER_CTA = 512;      // a CTA more for every so many points
constexpr int ADF_MAX_PARTIALS = 8;          // max(ADF_NW, ADF_MAX_CLUSTER)
constexpr size_t ADF_STAGE_LIMIT = 160 * 1024;  // stage xi, wn if the layout stays below
constexpr double ADF_SQ_FLOOR = 1e-12;       // K3, K4: 'sq' takes sqrt(max(a, 1e-12))

static_assert((ADF_PB_ONE & (ADF_PB_ONE - 1)) == 0 && (ADF_PB_CLUSTER & (ADF_PB_CLUSTER - 1)) == 0,
              "points a lane must be a power of two");
static_assert(ADF_NW <= ADF_MAX_PARTIALS && ADF_MAX_CLUSTER <= ADF_MAX_PARTIALS, "");

// CTAs per file: a function of the number of sigma points alone.
__host__ __device__ inline int adf_cluster_size(int S) {
  const int r = (S + ADF_POINTS_PER_CTA - 1) / ADF_POINTS_PER_CTA;
  return r < 1 ? 1 : (r > ADF_MAX_CLUSTER ? ADF_MAX_CLUSTER : r);
}

// Sigma points a lane takes per round, from the cluster size.
__host__ __device__ inline int adf_points_per_lane(int R) {
  return R > 1 ? ADF_PB_CLUSTER : ADF_PB_ONE;
}

// n values of T that load and store as one access where 16 bytes allow.
template <typename T, int n>
struct alignas(sizeof(T) * n >= 16 ? 16 : sizeof(T) * n) Pack {
  T v[n];
};

// The thread mapping and the shared layout (offsets in elements of T, every
// segment a multiple of four elements so the Packs stay aligned).
struct AdfLayout {
  int lg, G;      // lanes a point: G = 1 << lg
  int GW, GC;     // groups a warp, groups a CTA
  int PT, lgPT;   // points a warp takes per round
  int Dp;         // padded width G * ADF_DB (subbands and modulators)
  int rec;        // length of a partial record: G * ADF_NACC totals + the shift
  int nloc;       // sigma points a CTA walks, rounds * GC * PB
  int staged;     // xi, wn rows in shared memory
  int fmu, hph, mug, sdg, Wt, lk, part, cta, xi, wn, total;
};

__host__ __device__ inline int adf_r4(int x) { return (x + 3) & ~3; }

__host__ __device__ inline AdfLayout adf_layout(int D, int N, int S, int R, size_t elem) {
  AdfLayout L;
  const int PB = adf_points_per_lane(R);
  const int width = D > N ? D : N;
  L.lg = 0;
  while ((ADF_DB << L.lg) < width && L.lg < 5) ++L.lg;
  L.G = 1 << L.lg;
  L.GW = 32 >> L.lg;
  L.GC = ADF_NW * L.GW;
  L.PT = L.GW * PB;
  L.lgPT = 0;
  while ((1 << L.lgPT) < L.PT) ++L.lgPT;
  L.Dp = L.G * ADF_DB;
  L.rec = adf_r4(L.G * ADF_NACC + 1);
  const int per_round = R * L.GC * PB;
  L.nloc = ((S + per_round - 1) / per_round) * L.GC * PB;
  int o = 0;
  L.fmu = o; o += L.Dp;
  L.hph = o; o += L.Dp;
  L.mug = o; o += L.Dp;
  L.sdg = o; o += L.Dp;
  L.Wt = o; o += N * L.Dp;
  L.lk = o; o += adf_r4(ADF_NW * N * L.PT);
  L.part = o; o += ADF_NW * L.rec;
  L.cta = o; o += R > 1 ? 2 * L.rec : 0;
  const size_t stage = (size_t)adf_r4(L.nloc * N) + adf_r4(L.nloc);
  L.staged = ((size_t)o + stage) * elem <= ADF_STAGE_LIMIT;
  L.xi = o; o += L.staged ? adf_r4(L.nloc * N) : 0;
  L.wn = o; o += L.staged ? adf_r4(L.nloc) : 0;
  L.total = o;
  return L;
}

// Weight of a partial kept under shift m_part in a merge at shift m_all; a
// partial with no point (shift -inf) weighs zero, whatever m_all is.
template <typename T>
__device__ __forceinline__ T shift_scale(T m_part, T m_all) {
  return m_part == T(-INFINITY) ? T(0) : Num<T>::exp_(m_part - m_all);
}

// Merge P <= ADF_MAX_PARTIALS partial records in the order p = 0 .. P-1:
// the merged shift is returned, out[v] is the total of slot[v].  rec(p) is
// record p; its shift is at index mslot.
template <typename T, int NV, typename RecFn>
__device__ __forceinline__ T merge_partials(int P, RecFn rec, int mslot, const int (&slot)[NV],
                                            T (&out)[NV]) {
  T m[ADF_MAX_PARTIALS], mall = T(-INFINITY);
#pragma unroll
  for (int p = 0; p < ADF_MAX_PARTIALS; ++p) {
    m[p] = p < P ? rec(p)[mslot] : T(-INFINITY);
    mall = m[p] > mall ? m[p] : mall;
  }
#pragma unroll
  for (int v = 0; v < NV; ++v) out[v] = T(0);
#pragma unroll
  for (int p = 0; p < ADF_MAX_PARTIALS; ++p)
    if (p < P) {
      const T sc = shift_scale(m[p], mall);
      const T* r = rec(p);
#pragma unroll
      for (int v = 0; v < NV; ++v) out[v] += r[slot[v]] * sc;
    }
  return mall;
}

// Probe phases: 0 predict, 1 link values, 2 amplitudes, 3 s2e / mean and
// their butterfly, 4 weights, 5 totals, 6 merge, 7 cluster barrier, 8 site
// and update; slot ADF_PROBE_PHASES holds the observed steps.
constexpr int ADF_PROBE_PHASES = 9;

// clock64() sums per phase of one thread (with -DNSGP_CLOCK_PROBE; without
// it an empty shell that compiles to nothing).
struct AdfProbe {
#ifdef NSGP_CLOCK_PROBE
  bool on;
  long long cyc[ADF_PROBE_PHASES];
  long long last;
  __device__ __forceinline__ explicit AdfProbe(bool on_) : on(on_), cyc{}, last(clock64()) {}
  __device__ __forceinline__ void mark(int i) {
    if (on) {
      const long long now = clock64();
      cyc[i] += now - last;
      last = now;
    }
  }
  __device__ __forceinline__ void write(long long* out, int n_seen) const {
    if (on) {
      for (int i = 0; i < ADF_PROBE_PHASES; ++i) out[i] = cyc[i];
      out[ADF_PROBE_PHASES] = n_seen;
    }
  }
#else
  __device__ __forceinline__ explicit AdfProbe(bool) {}
  __device__ __forceinline__ void mark(int) {}
  __device__ __forceinline__ void write(long long*, int) const {}
#endif
};

// What the moment match of every ADF sweep reads: the observation stream and
// the likelihood.  y, obs (T, BF): the samples, and the steps whose moments
// are matched (obs > 0; uniform over a file's cluster); W (BF, D, N); sn2
// (BF,); xi (S, N), wn (S,) unit sigma points shared by the files.  'sq'
// amplitudes are sqrt(max(a, sq_floor)).  R, the CTAs a file, is set by
// launch_adf_sweep from S.
template <typename T>
struct AdfCore {
  const T* y;
  const T* obs;
  const T* W;
  const T* xi;
  const T* wn;
  const T* sn2;
  T damp, log_floor, sq_floor;
  int n_steps, BF, D, N, S, R, link_exp, sq;
  long long* cyc;
};

template <typename T>
AdfCore<T> adf_core(const void* y, const void* obs, const void* W, const void* xi, const void* wn,
                    const void* sn2, double damp, double log_floor, double sq_floor, int n_steps,
                    int BF, int D, int N, int S, int link_exp, int sq, void* cyc) {
  return AdfCore<T>{(const T*)y, (const T*)obs, (const T*)W, (const T*)xi, (const T*)wn,
                    (const T*)sn2, (T)damp, (T)log_floor, (T)sq_floor, n_steps, BF, D, N, S,
                    /*R=*/1, link_exp, sq, (long long*)cyc};
}

// The first half of phase 4, shared by the recursions: a channel's merged
// totals at shift m_all (Z, and the first and second weighted moments) to lZ
// and the first two derivatives of log Z at the cavity (fmu, var), with the
// raw-scale Z floor.  A modulator's totals are of the unit point: sd / var and
// 1 / var factor out here.
template <typename T>
__device__ __forceinline__ void adf_derivatives(T (&tot)[3], T m_all, bool modulator, T var, T sd,
                                                T log_floor, T& lZk, T& dl, T& d2) {
  if (!Num<T>::finite(m_all)) m_all = T(0);
  if (modulator) {
    // G1 = sum w dmu, G2 = sum w (dmu^2 - 1 / s2_g) with dmu = rg * x
    const T is2 = T(1) / var, rg = sd * is2;
    tot[1] *= rg;
    tot[2] = tot[2] * (rg * rg) - is2 * tot[0];
  }
  const T Z0 = clamp_min(tot[0], Num<T>::tiny());
  const T lZ_raw = m_all + Num<T>::log_(Z0);
  lZk = clamp_min(lZ_raw, log_floor);  // floor on the raw sum, not the shifted
  const T Zi = Num<T>::exp_(lZ_raw - lZk) / Z0;
  dl = Zi * tot[1];
  d2 = Zi * tot[2] - dl * dl;
}

// ---------------------------------------------------------------------------
// The recursion a sweep carries between its moment matches (phases 1 and 4).
// A recursion is a struct of one channel's state with three members:
//
//   Rec(args, core, b, c, chan, extra)   every thread: stage what the CTA
//       shares into `extra` (shared memory after the sweep's layout); the
//       channel threads (chan) load channel c of file b
//   marginal(t, fmu, var)                channel threads, phase 1: the
//       predicted observable marginal of step t
//   advance(t, matched, lZk, dl, d2, fmu, var, store)   channel threads,
//       phase 4: the site from the derivatives (zero where not matched) and
//       the state update; `store` on cluster rank 0 writes the outputs
//
// CovRecursion is K3's and K4's (the covariance filter); K5's steady-table
// recursion is in fused_ihgp_adf.cuh.
// ---------------------------------------------------------------------------

// K3, K4: ms (T, BF, C, bs), Ps (T, BF, C, bs, bs), lZ (T, BF), tt, tn
// (T, BF, C); A, Q, Pinf (BF, C, bs, bs), H (BF, C, bs).
template <typename T>
struct CovArgs {
  const T* A;
  const T* Q;
  const T* Pinf;
  const T* H;
  T* ms;
  T* Ps;
  T* lZ;
  T* tt;
  T* tn;
};

template <typename T>
CovArgs<T> cov_args(const void* A, const void* Q, const void* Pinf, const void* H, void* ms,
                    void* Ps, void* lZ, void* tt, void* tn) {
  return CovArgs<T>{(const T*)A, (const T*)Q, (const T*)Pinf, (const T*)H, (T*)ms, (T*)Ps,
                    (T*)lZ, (T*)tt, (T*)tn};
}

// EP sweep 1 from zero sites: predict (A m, A P A' + Q), the damped site from
// zero incoming sites, the rank-one update.
template <typename T, int BS>
struct CovRecursion {
  using Args = CovArgs<T>;
  Args a;
  T A[BS][BS], Q[BS][BS], P[BS][BS], H[BS], m[BS];
  T mp[BS], Pp[BS][BS], PH[BS];  // this step's prediction
  T damp;
  int b, c, C, BF;

  __device__ __forceinline__ CovRecursion(const Args& args, const AdfCore<T>& core, int b_, int c_,
                                          bool chan, T*)
      : a(args), damp(core.damp), b(b_), c(c_), C(core.D + core.N), BF(core.BF) {
    if (chan) {
      const size_t ch = (size_t)b * C + c;
      load_mat<T, BS>(A, a.A + ch * BS * BS);
      load_mat<T, BS>(Q, a.Q + ch * BS * BS);
      load_mat<T, BS>(P, a.Pinf + ch * BS * BS);
#pragma unroll
      for (int i = 0; i < BS; ++i) {
        H[i] = a.H[ch * BS + i];
        m[i] = T(0);
      }
    }
  }

  __device__ __forceinline__ void marginal(int, T& fmu, T& var) {
    T AP[BS][BS];
    predict<T, BS>(A, Q, m, P, mp, AP, Pp);
    observe<T, BS>(H, mp, Pp, fmu, PH, var);
  }

  __device__ __forceinline__ void advance(int t, bool matched, T lZk, T dl, T d2, T fmu, T var,
                                          bool store) {
    T tt = T(0), tn = T(0);  // not matched (unobserved): zero sites, lZ = 0
    if (matched) {
      const T denom = T(1) + d2 * var;
      // incoming sites are zero: (1 - damp) * 0 + damp * (...)
      tt = clamp_min(damp * (-d2 / denom), T(0));
      tn = damp * ((dl - fmu * d2) / denom);
    }
    site_update<T, BS>(tt, tn, fmu, var, PH, mp, Pp, m, P);
    if (store) {
      const size_t row = ((size_t)t * BF + b) * C + c;
      a.tt[row] = tt;
      a.tn[row] = tn;
      if (c == 0) a.lZ[(size_t)t * BF + b] = lZk;
#pragma unroll
      for (int i = 0; i < BS; ++i) a.ms[row * BS + i] = m[i];
      store_mat<T, BS>(a.Ps + row * BS * BS, P);
    }
  }
};

// One CTA's share of the moment match of a sweep over file b by its cluster
// of R CTAs: the thread map, the shared layout, and what is staged once per
// launch (the padding, W transposed, the CTA's own sigma points).  Built by
// every thread; a __syncthreads() must follow before the first step.  Its
// members are the phases of a step that every thread runs: publish (the
// channel threads' marginals, end of phase 1), match (phases 2 and 3: the
// totals of the sigma points, merged into the channel threads) and match_vjp
// (the reverse of match, for the adjoint kernels).  R is a parameter of its
// own so that the one-CTA instantiation folds it to 1.
template <typename T, int PB>
struct AdfStep {
  static constexpr int NT = ADF_THREADS, NW = ADF_NW, DB = ADF_DB, NACC = ADF_NACC;
  AdfLayout L;
  const T* xi;
  const T* wn;
  T sn2, sq_floor;
  int D, N, S, R, rank, tid, w, lane, g_lane, grp, d0, round_pts, own, mslot;
  int slots[3];  // where this channel's Z and two totals sit in a record
  bool link_exp, sq, chan;
  T* sh;
  T* fmu_z;   // [Dp] subband means, zero beyond D
  T* hph_z;   // [Dp] subband variances, zero beyond D
  T* mu_g;    // [Dp] modulator means, zero beyond N
  T* sd_g;    // [Dp] sqrt(max(s2_g, 0)), zero beyond N
  T* Wt;      // [N][Dp] W transposed, zero beyond D
  T* lk_w;    // [N][PT] this warp's link values
  T* part;    // [NW][rec] the warps' partial records
  T* cta_rec; // [2][rec] this CTA's merged record, double-buffered
  const T* xi_sh;  // [nloc][N] this CTA's sigma points, in walking order
  const T* wn_sh;  // [nloc]

  __device__ __forceinline__ AdfStep(const AdfCore<T>& core, int b, const int R_, T* sh_)
      : L(adf_layout(core.D, core.N, core.S, R_, sizeof(T))), xi(core.xi), wn(core.wn),
        sq_floor(core.sq_floor), D(core.D), N(core.N), S(core.S), R(R_),
        link_exp(core.link_exp != 0), sq(core.sq != 0), sh(sh_) {
    tid = threadIdx.x;
    w = tid >> 5;
    lane = tid & 31;
    rank = R > 1 ? (int)cg::this_cluster().block_rank() : 0;
    g_lane = lane & (L.G - 1);
    grp = lane >> L.lg;
    d0 = g_lane * DB;  // this lane's subbands and modulators
    const int Dp = L.Dp;
    fmu_z = sh + L.fmu;
    hph_z = sh + L.hph;
    mu_g = sh + L.mug;
    sd_g = sh + L.sdg;
    Wt = sh + L.Wt;
    lk_w = sh + L.lk + w * N * L.PT;
    part = sh + L.part;
    cta_rec = sh + L.cta;
    xi_sh = sh + L.xi;
    wn_sh = sh + L.wn;
    // ---- once per launch: padding, W, the CTA's own sigma points ----------
    round_pts = L.GC * PB;  // points a CTA takes per round
    for (int i = tid; i < 4 * Dp; i += NT) sh[L.fmu + i] = T(0);
    const T* W = core.W + (size_t)b * D * N;
    for (int i = tid; i < N * Dp; i += NT) {
      const int n = i / Dp, d = i - n * Dp;
      Wt[i] = d < D ? W[d * N + n] : T(0);
    }
    if (L.staged) {
      T* xs = sh + L.xi;
      T* ws = sh + L.wn;
      for (int loc = tid; loc < L.nloc; loc += NT) {
        const int kr = loc / round_pts;
        const int s = (kr * R + rank) * round_pts + (loc - kr * round_pts);
        ws[loc] = s < S ? wn[s] : T(0);
        for (int n = 0; n < N; ++n) xs[loc * N + n] = s < S ? xi[(size_t)s * N + n] : T(0);
      }
    }
    sn2 = core.sn2[b];
    chan = tid < D + N;  // channel tid of file b
    own = tid < D ? tid : tid - D;
    const int k1 = (own / DB) * NACC + 1 + (tid < D ? 0 : 2 * DB) + own % DB;
    slots[0] = 0;
    slots[1] = k1;
    slots[2] = k1 + DB;
    mslot = L.G * NACC;
  }

  // End of phase 1, a channel thread of a matched step: its predicted
  // marginal where the points read it (a modulator's sd = sqrt(max(var, 0))).
  __device__ __forceinline__ void publish(T fmu, T var, T& sd) const {
    if (tid < D) {
      fmu_z[tid] = fmu;
      hph_z[tid] = var;
    } else {
      sd = Num<T>::sqrt_(clamp_min(var, T(0)));
      mu_g[own] = fmu;
      sd_g[own] = sd;
    }
  }

  // The warp's first point in round k, and the rows of its PT points:
  // staged in walking order, or global.
  __device__ __forceinline__ int first_point(int k) const {
    return (k * R + rank) * round_pts + w * L.PT;
  }
  __device__ __forceinline__ const T* xi_rows(int k, int s0) const {
    return L.staged ? xi_sh + (k * round_pts + w * L.PT) * N : xi + (size_t)s0 * N;
  }
  __device__ __forceinline__ const T* wn_rows(int k, int s0) const {
    return L.staged ? wn_sh + k * round_pts + w * L.PT : wn + s0;
  }

  // Link values of the warp's PT points, shared out over the lanes, into the
  // warp's stash (zero past S).  One CTA a file runs one or two passes of
  // this loop a step, and a smaller loop body (less code to fetch each step)
  // beats an unrolled one there; in a cluster the warp takes many rounds and
  // unrolling pays.
  __device__ __forceinline__ void link_values(int s0, const T* xi_w) const {
#pragma unroll(PB == ADF_PB_ONE ? 1 : 4)
    for (int idx = lane; idx < (N << L.lgPT); idx += 32) {
      const int pt = idx & (L.PT - 1), n = idx >> L.lgPT;
      T v = T(0);
      if (s0 + pt < S) {
        v = link_fn(mu_g[n] + sd_g[n] * xi_w[pt * N + n], link_exp);
      }
      lk_w[n * L.PT + pt] = v;
    }
  }

  // Raw amplitudes W link(x) of the lane's PB points x DB subbands, from the
  // warp's stash (which the caller keeps until a __syncwarp()).
  __device__ __forceinline__ void amplitudes(T (&a)[PB][DB]) const {
#pragma unroll
    for (int p = 0; p < PB; ++p)
#pragma unroll
      for (int j = 0; j < DB; ++j) a[p][j] = T(0);
    const T* lkp = lk_w + grp * PB;
    const T* wp = Wt + d0;
#pragma unroll 3
    for (int n = 0; n < N; ++n) {
      const Pack<T, PB> lv = *reinterpret_cast<const Pack<T, PB>*>(lkp + n * L.PT);
      const Pack<T, DB> wv = *reinterpret_cast<const Pack<T, DB>*>(wp + n * L.Dp);
#pragma unroll
      for (int p = 0; p < PB; ++p)
#pragma unroll
        for (int j = 0; j < DB; ++j) a[p][j] += lv.v[p] * wv.v[j];
    }
  }

  // 'sq' amplitudes in place, then every point's s2e - sn2 and mean, summed
  // over the group's G lanes (a butterfly: all G lanes get the sums).
  __device__ __forceinline__ void point_sums(T (&a)[PB][DB], const Pack<T, DB>& hz,
                                             const Pack<T, DB>& mz, T (&se)[PB],
                                             T (&mean)[PB]) const {
    if (sq) {
#pragma unroll
      for (int p = 0; p < PB; ++p)
#pragma unroll
        for (int j = 0; j < DB; ++j) a[p][j] = Num<T>::sqrt_pos(clamp_min(a[p][j], sq_floor));
    }
#pragma unroll
    for (int p = 0; p < PB; ++p) {
      se[p] = T(0);
      mean[p] = T(0);
#pragma unroll
      for (int j = 0; j < DB; ++j) {
        se[p] += a[p][j] * a[p][j] * hz.v[j];  // zero beyond D
        mean[p] += a[p][j] * mz.v[j];
      }
    }
    for (int off = 1; off < L.G; off <<= 1) {
#pragma unroll
      for (int p = 0; p < PB; ++p) {
        se[p] += __shfl_xor_sync(0xffffffffu, se[p], off);
        mean[p] += __shfl_xor_sync(0xffffffffu, mean[p], off);
      }
    }
  }

  // A point's s2e, residual and log-normaliser.
  __device__ __forceinline__ void scalars(T yk, T se_, T mean_, T& rs, T& inv, T& ln) const {
    const T s2e = sn2 + se_;
    const T resid = yk - mean_;
    inv = T(1) / s2e;
    rs = resid * inv;
    ln = T(-0.5) * (resid * rs + Num<T>::log_(s2e) + T(LOG2PI));
  }

  // exp(ln - m) for a point that counts; a NaN poisons, -inf adds zero
  static __device__ __forceinline__ T weight(bool ok, T ln, T m) {
    return !ok || ln == T(-INFINITY) ? T(0) : Num<T>::exp_(ln - m);
  }

  // Phases 2 and 3 of a matched step (after every channel thread's publish):
  // the channel threads get their Z and two totals at the merged shift
  // m_all.  n_seen (matched steps so far) picks the cluster's buffer.
  __device__ __forceinline__ void match(T yk, int n_seen, T (&tot)[3], T& m_all,
                                        AdfProbe& probe) const {
    __syncthreads();
    probe.mark(0);

    // ---- 2. this lane's share of the totals, under its own shift -------
    T acc[NACC], m_run = T(-INFINITY);
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[i] = T(0);
    for (int k = 0;; ++k) {
      const int s0 = first_point(k);
      if (s0 >= S) break;  // uniform over the warp
      const T* xi_w = xi_rows(k, s0);
      const T* wn_w = wn_rows(k, s0);
      link_values(s0, xi_w);
      __syncwarp();
      probe.mark(1);
      T a[PB][DB];
      amplitudes(a);
      __syncwarp();  // the stash may be overwritten by the next round
      probe.mark(2);
      const Pack<T, DB> hz = *reinterpret_cast<const Pack<T, DB>*>(hph_z + d0);
      const Pack<T, DB> mz = *reinterpret_cast<const Pack<T, DB>*>(fmu_z + d0);
      T se[PB], mean[PB];
      point_sums(a, hz, mz, se, mean);
      probe.mark(3);
      // Per point: s2e, residual, log-normaliser; then the weights at the
      // lane's shift, raised first if a point of this round exceeds it.
      T wns[PB], wr[PB], wc[PB], al;
      if (L.G >= PB) {
        // lane p of the group does point p and hands its weights round
        const int pm = g_lane & (PB - 1);
        T se_m = se[0], mean_m = mean[0];
#pragma unroll
        for (int p = 1; p < PB; ++p)
          if (pm == p) {
            se_m = se[p];
            mean_m = mean[p];
          }
        const bool ok = s0 + grp * PB + pm < S;
        T rs, inv, ln;
        scalars(yk, se_m, mean_m, rs, inv, ln);
        T mx = ok && ln == ln ? ln : T(-INFINITY);  // a NaN never wins
#pragma unroll
        for (int off = 1; off < PB; off <<= 1) {
          const T o = __shfl_xor_sync(0xffffffffu, mx, off);
          mx = o > mx ? o : mx;
        }
        const T m_new = mx > m_run ? mx : m_run;
        al = shift_scale(m_run, m_new);
        m_run = m_new;
        T wv = T(0);
        if (ok) wv = wn_w[grp * PB + pm];
        const T wns_m = wv * weight(ok, ln, m_new);
        const T wr_m = wns_m * rs, wc_m = wns_m * (rs * rs - inv);
        const int first = lane & ~(L.G - 1);
#pragma unroll
        for (int p = 0; p < PB; ++p) {
          wns[p] = __shfl_sync(0xffffffffu, wns_m, first + p);
          wr[p] = __shfl_sync(0xffffffffu, wr_m, first + p);
          wc[p] = __shfl_sync(0xffffffffu, wc_m, first + p);
        }
      } else {
        // fewer lanes than points (D, N <= ADF_DB * G): every lane does all
        T rs[PB], inv[PB], ln[PB], m_new = m_run;
        bool ok[PB];
#pragma unroll
        for (int p = 0; p < PB; ++p) {
          ok[p] = s0 + grp * PB + p < S;
          scalars(yk, se[p], mean[p], rs[p], inv[p], ln[p]);
          if (ok[p] && ln[p] > m_new) m_new = ln[p];
        }
        al = shift_scale(m_run, m_new);
        m_run = m_new;
#pragma unroll
        for (int p = 0; p < PB; ++p) {
          T wv = T(0);
          if (ok[p]) wv = wn_w[grp * PB + p];
          wns[p] = wv * weight(ok[p], ln[p], m_new);
          wr[p] = wns[p] * rs[p];
          wc[p] = wns[p] * (rs[p] * rs[p] - inv[p]);
        }
      }
      probe.mark(4);
#pragma unroll
      for (int i = 0; i < NACC; ++i) acc[i] *= al;
#pragma unroll
      for (int p = 0; p < PB; ++p) {
        const int pt = grp * PB + p;
        if (s0 + pt < S) {
          acc[0] += wns[p];
#pragma unroll
          for (int j = 0; j < DB; ++j) {
            acc[1 + j] += wr[p] * a[p][j];
            acc[1 + DB + j] += wc[p] * (a[p][j] * a[p][j]);
            const T x = d0 + j < N ? xi_w[pt * N + d0 + j] : T(0);
            // the unit point's first two weighted moments; the channel
            // thread scales them to G1, G2 (rg and 1 / s2_g factor out)
            acc[1 + 2 * DB + j] += wns[p] * x;
            acc[1 + 3 * DB + j] += wns[p] * (x * x);
          }
        }
      }
      probe.mark(5);
    }
    // ---- 3. merge: groups of a warp, warps of a CTA, CTAs of a cluster --
    {  // the warp's shift first, one rescale, then plain butterfly sums
      T mw = m_run;
      for (int off = L.G; off < 32; off <<= 1) {
        const T o = __shfl_xor_sync(0xffffffffu, mw, off);
        mw = o > mw ? o : mw;
      }
      const T sc = shift_scale(m_run, mw);
#pragma unroll
      for (int i = 0; i < NACC; ++i) acc[i] *= sc;
      for (int off = L.G; off < 32; off <<= 1) {
#pragma unroll
        for (int i = 0; i < NACC; ++i) acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], off);
      }
      m_run = mw;
    }
    if (grp == 0) {  // group 0 holds the warp's record
      T* pr = part + w * L.rec;
#pragma unroll
      for (int i = 0; i < NACC; ++i) pr[g_lane * NACC + i] = acc[i];
      if (g_lane == 0) pr[mslot] = m_run;
    }
    __syncthreads();
    if (R > 1) {
      cg::cluster_group cluster = cg::this_cluster();
      T* mine = cta_rec + (n_seen & 1) * L.rec;
      const auto warp_rec = [&](int p) { return part + p * L.rec; };
      for (int idx = tid; idx < mslot; idx += NT) {
        const int one[1] = {idx};
        T v[1];
        const T mw = merge_partials<T, 1>(NW, warp_rec, mslot, one, v);
        mine[idx] = v[0];
        if (idx == 0) mine[mslot] = mw;
      }
      probe.mark(6);
      cluster.sync();
      probe.mark(7);
      if (chan)
        m_all = merge_partials<T, 3>(
            R, [&](int p) { return cluster.map_shared_rank(mine, p); }, mslot, slots, tot);
    } else {
      probe.mark(6);
      if (chan)
        m_all = merge_partials<T, 3>(
            NW, [&](int p) { return part + p * L.rec; }, mslot, slots, tot);
    }
  }

  // The reverse of match for one CTA (R = 1), after every channel thread's
  // publish of the step: the cotangents of the totals to those of the
  // channels' marginals, one pass over the points.  gZ is Z's cotangent; g4
  // [4][Dp] in shared memory holds those of A1, A2 (subbands) and of the unit
  // point's two weighted moments (modulators), zero beyond D and N.  Every
  // point is re-evaluated at the merged shift m_all (finite), its weight
  // exp(ln - m_all) differentiated with the shift held constant.  Adds this
  // lane's share of sn2's cotangent to gsn2 (group lane 0) and of W's to
  // wacc[(n DB + j) NT + tid] (float64); lkbar_w [N][PT] is the warp's stash
  // for the link values' cotangents.  Returns in the channel threads g_mu (the
  // mean's cotangent) and g_s (a subband's variance's, a modulator's sd's).
  __device__ __forceinline__ void match_vjp(T yk, T m_all, T gZ, const T* g4, T* lkbar_w,
                                            double* wacc, double& gsn2, T& g_mu, T& g_s) const {
    constexpr int NV = 4 * DB;  // a lane's sums: mu_z, s2_z, mu_g, sd of its DB channels
    const int PT = L.PT, Dp = L.Dp;
    T acc[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) acc[i] = T(0);
    const Pack<T, DB> gA1 = *reinterpret_cast<const Pack<T, DB>*>(g4 + d0);
    const Pack<T, DB> gA2 = *reinterpret_cast<const Pack<T, DB>*>(g4 + Dp + d0);
    const Pack<T, DB> gX1 = *reinterpret_cast<const Pack<T, DB>*>(g4 + 2 * Dp + d0);
    const Pack<T, DB> gX2 = *reinterpret_cast<const Pack<T, DB>*>(g4 + 3 * Dp + d0);
    const Pack<T, DB> hz = *reinterpret_cast<const Pack<T, DB>*>(hph_z + d0);
    const Pack<T, DB> mz = *reinterpret_cast<const Pack<T, DB>*>(fmu_z + d0);
    for (int k = 0;; ++k) {
      const int s0 = first_point(k);
      if (s0 >= S) break;  // uniform over the warp
      const T* xi_w = xi_rows(k, s0);
      const T* wn_w = wn_rows(k, s0);
      link_values(s0, xi_w);
      __syncwarp();
      T a[PB][DB], ar[PB][DB], se[PB], mean[PB];
      amplitudes(a);
#pragma unroll
      for (int p = 0; p < PB; ++p)
#pragma unroll
        for (int j = 0; j < DB; ++j) ar[p][j] = a[p][j];
      point_sums(a, hz, mz, se, mean);
      // every lane: its PB points' weights and scalars, the unit points, and
      // its share of the sums the point's cotangents need
      T wns[PB], rs[PB], inv[PB], c2[PB], x[PB][DB], u[3][PB];
      bool ok[PB];
#pragma unroll
      for (int p = 0; p < PB; ++p) {
        const int pt = grp * PB + p;
        ok[p] = s0 + pt < S;
        T ln;
        scalars(yk, se[p], mean[p], rs[p], inv[p], ln);
        wns[p] = ok[p] ? wn_w[pt] * weight(true, ln, m_all) : T(0);
        c2[p] = rs[p] * rs[p] - inv[p];
        u[0][p] = u[1][p] = u[2][p] = T(0);
#pragma unroll
        for (int j = 0; j < DB; ++j) {
          x[p][j] = ok[p] && d0 + j < N ? xi_w[pt * N + d0 + j] : T(0);
          u[0][p] += gA1.v[j] * a[p][j];
          u[1][p] += gA2.v[j] * (a[p][j] * a[p][j]);
          u[2][p] += gX1.v[j] * x[p][j] + gX2.v[j] * (x[p][j] * x[p][j]);
        }
      }
      for (int off = 1; off < L.G; off <<= 1) {
#pragma unroll
        for (int p = 0; p < PB; ++p)
#pragma unroll
          for (int q = 0; q < 3; ++q) u[q][p] += __shfl_xor_sync(0xffffffffu, u[q][p], off);
      }
      // per point: the cotangents of its weight, residual and s2e, then of
      // its amplitudes (ar holds them after this, on the raw scale)
#pragma unroll
      for (int p = 0; p < PB; ++p) {
        const T g_wns = gZ + rs[p] * u[0][p] + c2[p] * u[1][p] + u[2][p];
        const T g_rs = wns[p] * (u[0][p] + T(2) * rs[p] * u[1][p]);
        const T g_inv = -wns[p] * u[1][p];
        const T g_ln = g_wns * wns[p];
        const T g_resid = g_rs * inv[p] - g_ln * rs[p];
        const T g_s2e = T(0.5) * g_ln * c2[p] - g_rs * rs[p] * inv[p] - g_inv * inv[p] * inv[p];
        if (g_lane == 0 && ok[p]) gsn2 += (double)g_s2e;
        const T wr = wns[p] * rs[p], wc = T(2) * wns[p] * c2[p];
#pragma unroll
        for (int j = 0; j < DB; ++j) {
          const T aj = a[p][j];
          T ga = wr * gA1.v[j] + wc * gA2.v[j] * aj - g_resid * mz.v[j] + T(2) * g_s2e * aj * hz.v[j];
          acc[j] -= g_resid * aj;
          acc[DB + j] += g_s2e * (aj * aj);
          if (sq) ga = ar[p][j] >= sq_floor ? T(0.5) * ga / aj : T(0);
          ar[p][j] = ga;
        }
      }
      // W's cotangent (float64, this lane's subbands) and the link values'
      // (summed over the group, kept by the lane that owns the modulator)
      const T* lkp = lk_w + grp * PB;
      for (int n = 0; n < N; ++n) {
        T gl[PB];
#pragma unroll
        for (int p = 0; p < PB; ++p) gl[p] = T(0);
#pragma unroll
        for (int j = 0; j < DB; ++j) {
          const T wv = Wt[n * Dp + d0 + j];
          double s = 0.0;
#pragma unroll
          for (int p = 0; p < PB; ++p) {
            s += (double)(ar[p][j] * lkp[n * PT + p]);
            gl[p] += ar[p][j] * wv;
          }
          if (d0 + j < D) wacc[(size_t)(n * DB + j) * NT + tid] += s;
        }
        for (int off = 1; off < L.G; off <<= 1) {
#pragma unroll
          for (int p = 0; p < PB; ++p) gl[p] += __shfl_xor_sync(0xffffffffu, gl[p], off);
        }
        if (g_lane == n / DB) {
#pragma unroll
          for (int p = 0; p < PB; ++p) lkbar_w[n * PT + grp * PB + p] = gl[p];
        }
      }
      __syncwarp();
      // the modulators' x = mu_g + sd xi: their mean's and sd's cotangents
#pragma unroll
      for (int j = 0; j < DB; ++j) {
        const int n = d0 + j;
        if (n < N) {
#pragma unroll
          for (int p = 0; p < PB; ++p) {
            if (!ok[p]) continue;
            const int pt = grp * PB + p;
            const T lk = lk_w[n * PT + pt];
            const T dlk = link_exp ? lk : T(1) / (T(1) + Num<T>::exp_(-(mu_g[n] + sd_g[n] * x[p][j])));
            const T gx = lkbar_w[n * PT + pt] * dlk;
            acc[2 * DB + j] += gx;
            acc[3 * DB + j] += gx * x[p][j];
          }
        }
      }
      __syncwarp();  // the stashes may be overwritten by the next round
    }
    // ---- merge the lanes' sums: groups of a warp, then warps (fixed order)
    for (int off = L.G; off < 32; off <<= 1) {
#pragma unroll
      for (int i = 0; i < NV; ++i) acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], off);
    }
    if (grp == 0) {
      T* pr = part + w * L.rec;
#pragma unroll
      for (int i = 0; i < NV; ++i) pr[g_lane * NV + i] = acc[i];
    }
    __syncthreads();
    g_mu = g_s = T(0);
    if (chan) {
      const int base = (own / DB) * NV + (tid < D ? 0 : 2 * DB) + own % DB;
      for (int p = 0; p < NW; ++p) {
        g_mu += part[p * L.rec + base];
        g_s += part[p * L.rec + base + DB];
      }
    }
  }
};

// The sweep over one file b = blockIdx.x / R by its cluster of R CTAs, the
// recursion Rec carried between the moment matches.
template <typename T, int BS, int PB, typename Rec>
__device__ __forceinline__ void adf_sweep_pb(const AdfCore<T>& core, const typename Rec::Args& ra,
                                             const int R) {
  const T* __restrict__ y = core.y;
  const T* __restrict__ obs = core.obs;
  const int n_steps = core.n_steps, BF = core.BF, D = core.D;
  const int b = blockIdx.x / R;  // the file
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const AdfStep<T, PB> st(core, b, R, reinterpret_cast<T*>(smem_raw));
  const int tid = st.tid;
  const bool chan = st.chan;
  Rec rec(ra, core, b, tid, chan, st.sh + st.L.total);
  T y_next = y[b], obs_next = obs[b];
  int n_seen = 0;  // observed steps so far: the parity picks the cluster buffer
  __syncthreads();
  AdfProbe probe(tid == 0 && blockIdx.x == 0 && core.cyc != nullptr);

  for (int t = 0; t < n_steps; ++t) {
    const T yk = y_next;
    const bool observed = obs_next > T(0);  // uniform over the cluster
    if (t + 1 < n_steps) {
      y_next = y[(size_t)(t + 1) * BF + b];
      obs_next = obs[(size_t)(t + 1) * BF + b];
    }

    // ---- 1. the predicted marginals, published where the step is matched --
    T fmu = T(0), var = T(0);
    T sd = T(0);  // a modulator's sqrt(max(s2_g, 0))
    if (chan) {
      rec.marginal(t, fmu, var);
      if (observed) st.publish(fmu, var, sd);
    }

    // ---- 2, 3. the totals of the sigma points ------------------------------
    T tot[3] = {T(0), T(0), T(0)}, m_all = T(0);
    if (observed) {
      st.match(yk, n_seen, tot, m_all, probe);
      ++n_seen;
    }

    // ---- 4. derivatives, then the recursion's site and update -------------
    if (chan) {
      T lZk = T(0), dl = T(0), d2 = T(0);
      if (observed) adf_derivatives<T>(tot, m_all, tid >= D, var, sd, core.log_floor, lZk, dl, d2);
      rec.advance(t, observed, lZk, dl, d2, fmu, var, st.rank == 0);
    }
    probe.mark(8);
  }
  // No CTA may exit while another can still read its shared memory.
  if (R > 1) cg::this_cluster().sync();
  probe.write(core.cyc, n_seen);
}

template <typename T, int BS, typename Rec>
__device__ __forceinline__ void adf_sweep(const AdfCore<T>& core, const typename Rec::Args& ra) {
  if (core.R > 1)
    adf_sweep_pb<T, BS, ADF_PB_CLUSTER, Rec>(core, ra, core.R);
  else
    adf_sweep_pb<T, BS, ADF_PB_ONE, Rec>(core, ra, 1);
}

// Dynamic shared memory of the sweep's own layout for S sigma points.
template <typename T>
size_t adf_smem_bytes(int D, int N, int S) {
  return (size_t)adf_layout(D, N, S, adf_cluster_size(S), sizeof(T)).total * sizeof(T);
}

// The most dynamic shared memory a block may take (Hopper: 227 KB).
constexpr size_t ADF_SMEM_MAX = 232448;

// Launch `kern` (K3, K4 or K5) over core.BF files: BF clusters of R CTAs,
// with `extra` bytes of shared memory for the recursion after the sweep's
// layout.  Returns 0, a CUDA error, -2 for a width the mapping cannot take,
// -3 for a cluster that cannot be resident.  Within the accepted widths the
// sweep's layout stays under the block's 227 KB (the staged sigma points are
// dropped first); a recursion asks for `extra` only where it fits.
template <typename T, typename Args>
int launch_adf_sweep(void (*kern)(AdfCore<T>, Args), AdfCore<T> core, Args args, size_t extra,
                     cudaStream_t st) {
  const int D = core.D, N = core.N, S = core.S, BF = core.BF;
  if (D < 1 || N < 1 || S < 1 || BF < 1 || D > ADF_MAX_WIDTH || N > ADF_MAX_WIDTH ||
      D + N > ADF_THREADS)
    return -2;
  const int R = adf_cluster_size(S);
  core.R = R;
  const size_t bytes = adf_smem_bytes<T>(D, N, S) + extra;
  if (bytes > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(BF * R));
  cfg.blockDim = dim3(ADF_THREADS);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)R;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (R > 1) {
    int resident = 0;
    const cudaError_t e = cudaOccupancyMaxActiveClusters(&resident, kern, &cfg);
    if (e != cudaSuccess) return (int)e;
    if (resident < 1) return -3;
  }
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kern, core, args);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

}  // namespace
