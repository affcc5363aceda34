"""Fused filter / smoother / ADF passes: CUDA kernels and their plain twins.

Port of ``nsgp_tpu/ops/pallas_kalman.py``, and of the transposed scan that
``jax.value_and_grad`` derives from ``nsgp_tpu/ops/kalman.py:adf_filter``.
Six kernels, each a whole pass over T (``csrc/fused_kalman.cuh``,
``csrc/fused_adf.cuh``, ``csrc/fused_adf_mb.cuh``, ``csrc/fused_adf_vjp.cuh``,
``csrc/fused_resite.cuh``; K3, K4, K7 and K9 share their per-point moment
match, ``csrc/adf_step.cuh``).  K3, K4 and K9 are one launch each; K7 is two,
a pre-pass over all steps and the reverse walk; K1 and K2, whose steps
compose, run as three blocked parallel-in-time launches over chunks of T
(``chunk_length``), of which ``fused_*_blocked_plain`` are the plain versions:

    fused_fwd     (K1)  forward filter with fixed sites    <- _fwd_kernel
    fused_bwd     (K2)  RTS smoother with a Cholesky gain  <- _bwd_kernel
    fused_adf     (K3)  EP sweep 1: filter + in-step ADF   <- _adf_kernel
    fused_adf_mb  (K4)  K3 over BF files, a cluster of     <- _adf_kernel_mb
                        CTAs a file, sigma points streamed
    fused_adf_vjp (K7)  K3's sweep in reverse: cotangents  <- the transpose
                        of its outputs to its parameters'     of adf_filter
    fused_resite  (K9)  the all-T EP re-site: each site's  <- none (XLA ops
                        cavity, moment match and update       in the JAX
                        in one launch, a warp a site          package)

``FusedADF`` binds K3 and K7 as one ``torch.autograd.Function``;
``FusedResite`` binds K9 to the VJP of its plain twin, recomputed in its
backward (K9 has no adjoint kernel yet).

Each wrapper does exactly one of two things: on CPU tensors it runs its
plain PyTorch version (``*_plain``, same step order: predict from (0, Pinf)
at step 0 with no first-step skip, no symmetrisation, the Cholesky gain,
sqrt(max(a, 1e-12)) for 'sq'); on CUDA tensors it launches the kernel or
raises.  There is no fallback between the two.  Each wrapper counts its
kernel launches in ``<wrapper>.launches`` (one a call, whatever the passes),
through ``utils.trace.launched``: the host path and the launch run inside a
profiler span ``nsgp.K<n>``.

Trajectories are C-major, (T, C, bs) / (T, C, bs, bs), exactly T steps: the
TPU kernels' b-major (Tp*bs, C) rows and the padding of T to a block exist
only for TPU tiles.  K4's carry a file axis, (T, BF, C, ...), which viewed as
(T, BF*C, ...) is what K1 and K2 take: they run any number of channels.  The
kernels assume the stationary discretization Q = Pinf - A Pinf A' (the
``build_modulator_ssm`` default), under which one prediction from (0, Pinf)
is exactly (0, Pinf); the pass-level entry points check it once per call.
"""

from __future__ import annotations

import ctypes
import math

import torch

from nsgp_tpu_torch.ops.kalman import Sites
from nsgp_tpu_torch.ops.moments import (LINKS, MomentParams, _log_floor, moments_chunked,
                                         sigma_points)
from nsgp_tpu_torch.ops.ssm import BlockSSM
from nsgp_tpu_torch.utils.trace import launched, span

MAX_BLOCK = 8  # block sizes instantiated in csrc/*.cu
_LOG2PI = math.log(2.0 * math.pi)
# K7's record holds a per-point part (every sigma point's forward values, a
# step) only up to this many bytes; above it the reverse walk re-evaluates the
# points.  At T = 16 000, 77 points and D = 16 (the speech model's training)
# the part is 225 MB in float32.
VJP_STASH_BYTES = 1 << 30
_LAUNCH_CODES = {  # what csrc/adf_step.cuh:launch_adf_sweep returns besides CUDA errors
    -1: "unsupported block size or dtype",
    -2: "a width the thread mapping cannot take",
    -3: "the thread-block cluster cannot be resident on this card",
}


# ---------------------------------------------------------------------------
# Plain PyTorch versions (CPU path; reference for the kernels on the card)
# ---------------------------------------------------------------------------


def _predict(A, At, Q, m, P):
    return (A @ m[..., None])[..., 0], A @ P @ At + Q


def _observe(H, mp, Pp):
    fmu = (H * mp).sum(-1)
    PH = (Pp @ H[..., None])[..., 0]
    return fmu, PH, (H * PH).sum(-1)


def _update(tt, tn, fmu, HPH, PH, mp, Pp):
    z = tt * HPH + 1.0
    v = (tt * fmu - tn) / z
    w = tt / z
    m = mp - PH * v[..., None]
    P = Pp - w[..., None, None] * PH[..., :, None] * PH[..., None, :]
    return m, P


def fused_fwd_plain(ttau, tnu, A, Q, Pinf, H):
    """K1 reference.  ttau/tnu (T, C); A, Q, Pinf (C, bs, bs); H (C, bs).
    Returns filtered ms (T, C, bs), Ps (T, C, bs, bs)."""
    T, C = ttau.shape
    bs = H.shape[1]
    At = A.transpose(-1, -2)
    m = torch.zeros((C, bs), dtype=A.dtype, device=A.device)
    P = Pinf
    ms = torch.empty((T, C, bs), dtype=A.dtype, device=A.device)
    Ps = torch.empty((T, C, bs, bs), dtype=A.dtype, device=A.device)
    for t in range(T):
        mp, Pp = _predict(A, At, Q, m, P)
        fmu, PH, HPH = _observe(H, mp, Pp)
        m, P = _update(ttau[t], tnu[t], fmu, HPH, PH, mp, Pp)
        ms[t] = m
        Ps[t] = P
    return ms, Ps


def _chol_gain(M, AP, eps=1e-30):
    """G with G' = M^{-1} AP by an unrolled Cholesky of M (pivot floor eps),
    elementwise over the leading axes — the kernel's arithmetic, vectorised."""
    bs = M.shape[-1]
    L = [[None] * bs for _ in range(bs)]
    inv_d = [None] * bs
    for j in range(bs):
        s = M[..., j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        d = torch.sqrt(torch.clamp_min(s, eps))
        L[j][j] = d
        inv_d[j] = 1.0 / d
        for i in range(j + 1, bs):
            s = M[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv_d[j]
    # forward / back substitution on all columns of AP at once (rows i)
    y = [None] * bs
    for i in range(bs):
        s = AP[..., i, :]
        for k in range(i):
            s = s - L[i][k][..., None] * y[k]
        y[i] = s * inv_d[i][..., None]
    x = [None] * bs
    for i in reversed(range(bs)):
        s = y[i]
        for k in range(i + 1, bs):
            s = s - L[k][i][..., None] * x[k]
        x[i] = s * inv_d[i][..., None]
    return torch.stack(x, dim=-1)  # (..., l, i) = G[l][i]


def fused_bwd_plain(ms, Ps, A, Q, pad):
    """K2 reference.  ms (T, C, bs), Ps (T, C, bs, bs) filtered; A, Q
    (C, bs, bs); pad (C, bs) = 1 on zero-padded dims.  Returns smoothed
    (T, C, bs), (T, C, bs, bs).  The gains depend only on the filtered P_k,
    so they are formed for all steps at once; the loop is the affine
    recursion."""
    T = ms.shape[0]
    At = A.transpose(-1, -2)
    Am = (A @ ms[..., None])[..., 0]
    AP = A @ Ps
    Pp = AP @ At + Q
    G = _chol_gain(Pp + torch.diag_embed(pad), AP)
    Gt = G.transpose(-1, -2)
    sm = torch.empty_like(ms)
    sP = torch.empty_like(Ps)
    mn, Pn = Am[T - 1], Pp[T - 1]  # last step: smoothed == filtered
    for t in range(T - 1, -1, -1):
        mn = ms[t] + (G[t] @ (mn - Am[t])[..., None])[..., 0]
        Pn = Ps[t] + G[t] @ (Pn - Pp[t]) @ Gt[t]
        sm[t] = mn
        sP[t] = Pn
    return sm, sP


# ---------------------------------------------------------------------------
# The blocked passes of K1 and K2, as the kernels run them
# ---------------------------------------------------------------------------

MIN_CHUNK, MAX_CHUNK = 32, 512


def chunk_length(T: int, C: int) -> int:
    """Steps a chunk of the blocked K1 / K2 passes: a power of two in
    [32, 512].  Passes 1 and 3 walk L steps in every (chunk, channel) thread
    and pass 2 walks the T / L chunk totals in one thread a channel, so the
    dependent depth is about 2.5 L steps and T / L applications of a total,
    which cost about 1.7 steps each: least near sqrt(T / 1.5), as timed on an
    H100 at T = 16 000 .. 100 000 and C = 19, 57, 190
    (``tools/time_kalman.py --sweep``).  C does not enter the rule: no width
    that was timed moved the best length."""
    L = 2 ** round(0.5 * math.log2(max(T, 2) / 1.5))
    return min(max(L, MIN_CHUNK), MAX_CHUNK)


def _outer(u, v):
    return u[..., :, None] * v[..., None, :]


def _solve_pivoted(M, B):
    """X with M X = B by Gaussian elimination with partial pivoting, unrolled
    over the block size and elementwise over the leading axes (the kernel's
    arithmetic: the pivot row bubbles up by compare-and-swap of whole rows,
    one division a pivot).
    M (..., bs, bs), B (..., bs, k)."""
    bs = M.shape[-1]
    rows = [torch.cat([M[..., i, :], B[..., i, :]], dim=-1) for i in range(bs)]
    inv = [None] * bs
    for j in range(bs):
        for i in range(j + 1, bs):
            swap = (rows[i][..., j].abs() > rows[j][..., j].abs())[..., None]
            rows[j], rows[i] = (torch.where(swap, rows[i], rows[j]),
                                torch.where(swap, rows[j], rows[i]))
        inv[j] = 1.0 / rows[j][..., j]
        for i in range(j + 1, bs):
            rows[i] = rows[i] - (rows[i][..., j] * inv[j])[..., None] * rows[j]
    x = [None] * bs
    for i in reversed(range(bs)):
        s = rows[i][..., bs:]
        for k in range(i + 1, bs):
            s = s - rows[i][..., k, None] * x[k]
        x[i] = s * inv[i][..., None]
    return torch.stack(x, dim=-2)


def _fwd_total_step(A, At, Q, H, tt, tn, tot):
    """Pass 1 of K1: fold one step into a chunk's total (At, b, Cm, eta, J).
    (b, Cm) take the filter step of ``fused_fwd_plain`` from (0, 0), the
    moments given the chunk's incoming state x0; At is the linear part in x0;
    (eta, J) gather what the chunk's sites say of x0, each step one rank-one
    term through h = H At (the combine of ``ops.pscan`` with a single step on
    the right, whose (I + C J)^-1 is the scalar 1 / z here)."""
    Atot, b, Cm, eta, J = tot
    mp, Pp = _predict(A, At, Q, b, Cm)
    Ap = A @ Atot
    fmu, PH, HPH = _observe(H, mp, Pp)
    z = tt * HPH + 1.0
    v = (tt * fmu - tn) / z
    w = tt / z
    h = (H[..., :, None] * Ap).sum(-2)  # row H Ap
    eta = eta - h * v[..., None]
    J = J + w[..., None, None] * _outer(h, h)
    Atot = Ap - w[..., None, None] * _outer(PH, h)
    b, Cm = _update(tt, tn, fmu, HPH, PH, mp, Pp)
    return Atot, b, Cm, eta, J


def _fwd_apply_total(tot, m, P):
    """Pass 2 of K1: a chunk's total applied to its incoming state:
    D = (I + P J)^-1, m <- At D (m + P eta) + b, P <- At sym(D P) At' + Cm."""
    Atot, b, Cm, eta, J = tot
    bs = m.shape[-1]
    M = torch.eye(bs, dtype=m.dtype, device=m.device) + P @ J
    rhs = torch.cat([P, (m + (P @ eta[..., None])[..., 0])[..., None]], dim=-1)
    X = _solve_pivoted(M, rhs)
    DP = 0.5 * (X[..., :bs] + X[..., :bs].transpose(-1, -2))
    m = (Atot @ X[..., bs:])[..., 0] + b
    return m, Atot @ DP @ Atot.transpose(-1, -2) + Cm


def fused_fwd_blocked_plain(ttau, tnu, A, Q, Pinf, H, chunk=None):
    """K1 as the kernel computes it, in three passes over chunks of
    ``chunk`` steps (default ``chunk_length``), vectorised over chunks and
    channels.  One chunk is ``fused_fwd_plain`` itself."""
    T, C = ttau.shape
    bs = H.shape[1]
    L = chunk or chunk_length(T, C)
    nc = -(-T // L)
    if nc == 1:
        return fused_fwd_plain(ttau, tnu, A, Q, Pinf, H)
    At = A.transpose(-1, -2)
    kw = dict(dtype=A.dtype, device=A.device)
    padT = nc * L - T  # zero sites: predictions that are trimmed at the end
    tt = torch.nn.functional.pad(ttau, (0, 0, 0, padT)).reshape(nc, L, C)
    tn = torch.nn.functional.pad(tnu, (0, 0, 0, padT)).reshape(nc, L, C)
    # pass 1: totals of the chunks 0 .. nc-2 (the last one's is never used)
    tot = (torch.eye(bs, **kw).expand(nc - 1, C, bs, bs), torch.zeros((nc - 1, C, bs), **kw),
           torch.zeros((nc - 1, C, bs, bs), **kw), torch.zeros((nc - 1, C, bs), **kw),
           torch.zeros((nc - 1, C, bs, bs), **kw))
    for i in range(L):
        tot = _fwd_total_step(A, At, Q, H, tt[:-1, i], tn[:-1, i], tot)
    # pass 2: the state that enters each chunk, from (0, Pinf)
    m0 = torch.empty((nc, C, bs), **kw)
    P0 = torch.empty((nc, C, bs, bs), **kw)
    m0[0], P0[0] = 0.0, Pinf
    for k in range(nc - 1):
        m0[k + 1], P0[k + 1] = _fwd_apply_total(tuple(x[k] for x in tot), m0[k], P0[k])
    # pass 3: the sequential step inside every chunk, from its carry
    m, P = m0, P0
    ms = torch.empty((nc, L, C, bs), **kw)
    Ps = torch.empty((nc, L, C, bs, bs), **kw)
    for i in range(L):
        mp, Pp = _predict(A, At, Q, m, P)
        fmu, PH, HPH = _observe(H, mp, Pp)
        m, P = _update(tt[:, i], tn[:, i], fmu, HPH, PH, mp, Pp)
        ms[:, i] = m
        Ps[:, i] = P
    return ms.reshape(nc * L, C, bs)[:T], Ps.reshape(nc * L, C, bs, bs)[:T]


def fused_bwd_blocked_plain(ms, Ps, A, Q, pad, chunk=None):
    """K2 as the kernel computes it, in three passes over chunks of
    ``chunk`` steps.  Pass 1 runs the smoother step of ``fused_bwd_plain``
    from a zero carry in every chunk (that gives the affine map's constant
    part (g, L)) and multiplies the gains up (its linear part E); pass 2
    carries the state (mn, Pn) down the chunks; pass 3 is the sequential
    step from each chunk's carry.  One chunk is ``fused_bwd_plain`` itself."""
    T, C, bs = ms.shape
    L = chunk or chunk_length(T, C)
    nc = -(-T // L)
    if nc == 1:
        return fused_bwd_plain(ms, Ps, A, Q, pad)
    At = A.transpose(-1, -2)
    kw = dict(dtype=A.dtype, device=A.device)
    Am = (A @ ms[..., None])[..., 0]
    AP = A @ Ps
    Pp = AP @ At + Q
    G = _chol_gain(Pp + torch.diag_embed(pad), AP)
    padT = nc * L - T  # steps past the end leave every state as it is
    chunks = lambda x: torch.nn.functional.pad(
        x, (0, 0) * (x.dim() - 1) + (0, padT)).reshape((nc, L) + x.shape[1:])
    msc, Psc, Amc, Ppc, Gc = map(chunks, (ms, Ps, Am, Pp, G))
    live = (torch.arange(nc * L, device=A.device) < T).reshape(nc, L)

    def step(i, mn, Pn, E=None):
        g, keep = Gc[:, i], ~live[:, i]
        mn_new = msc[:, i] + (g @ (mn - Amc[:, i])[..., None])[..., 0]
        Pn_new = Psc[:, i] + g @ (Pn - Ppc[:, i]) @ g.transpose(-1, -2)
        mn = torch.where(keep[:, None, None], mn, mn_new)
        Pn = torch.where(keep[:, None, None, None], Pn, Pn_new)
        if E is None:
            return mn, Pn
        return mn, Pn, torch.where(keep[:, None, None, None], E, g @ E)

    # pass 1: totals of all chunks (chunk 0's is never used)
    g_t = torch.zeros((nc, C, bs), **kw)
    L_t = torch.zeros((nc, C, bs, bs), **kw)
    E_t = torch.eye(bs, **kw).expand(nc, C, bs, bs)
    for i in range(L - 1, -1, -1):
        g_t, L_t, E_t = step(i, g_t, L_t, E_t)
    # pass 2: the carry that enters each chunk from above; the last chunk's
    # makes the last step's smoothed moments equal its filtered ones
    mn = torch.empty((nc, C, bs), **kw)
    Pn = torch.empty((nc, C, bs, bs), **kw)
    mn[nc - 1], Pn[nc - 1] = Am[T - 1], Pp[T - 1]
    for k in range(nc - 1, 0, -1):
        mn[k - 1] = (E_t[k] @ mn[k][..., None])[..., 0] + g_t[k]
        Pn[k - 1] = E_t[k] @ Pn[k] @ E_t[k].transpose(-1, -2) + L_t[k]
    # pass 3
    sm = torch.empty((nc, L, C, bs), **kw)
    sP = torch.empty((nc, L, C, bs, bs), **kw)
    for i in range(L - 1, -1, -1):
        mn, Pn = step(i, mn, Pn)
        sm[:, i] = mn
        sP[:, i] = Pn
    return sm.reshape(nc * L, C, bs)[:T], sP.reshape(nc * L, C, bs, bs)[:T]


def fused_adf_plain(y, obs, A, Q, Pinf, H, W, xi, wn, sn2, *, damp, link, variant,
                    z_floor):
    """K3 reference: ADF forward sweep from zero sites.

    y, obs (T,) (obs 0/1); A, Q, Pinf (C, bs, bs); H (C, bs); W (D, N);
    xi (S, N), wn (S,) unit sigma points; sn2 () noise variance.  Returns
    ms (T, C, bs), Ps (T, C, bs, bs), lZ (T,), ttau, tnu (T, C).
    """
    T = y.shape[0]
    C, bs = H.shape
    D = W.shape[0]
    dt_, dev = A.dtype, A.device
    lk_fn = LINKS[link]
    At = A.transpose(-1, -2)
    Wt = W.T
    tiny = torch.finfo(dt_).tiny
    log_floor = float(torch.log(torch.tensor(z_floor, dtype=dt_)))
    observed = obs > 0
    m = torch.zeros((C, bs), dtype=dt_, device=dev)
    P = Pinf
    ms = torch.empty((T, C, bs), dtype=dt_, device=dev)
    Ps = torch.empty((T, C, bs, bs), dtype=dt_, device=dev)
    lZ = torch.empty((T,), dtype=dt_, device=dev)
    tts = torch.empty((T, C), dtype=dt_, device=dev)
    tns = torch.empty((T, C), dtype=dt_, device=dev)
    for t in range(T):
        mp, Pp = _predict(A, At, Q, m, P)
        fmu, PH, HPH = _observe(H, mp, Pp)
        # ---- cubature moments at the predicted marginal ------------------
        mu_z, mu_g = fmu[:D], fmu[D:]
        s2_z, s2_g = HPH[:D], HPH[D:]
        xn = mu_g + torch.sqrt(torch.clamp_min(s2_g, 0.0)) * xi  # (S, N)
        a = lk_fn(xn) @ Wt  # (S, D)
        if variant == "sq":
            a = torch.sqrt(torch.clamp_min(a, 1e-12))
        s2e = sn2 + (a * a * s2_z).sum(1)  # (S,)
        resid = y[t] - (a * mu_z).sum(1)
        log_norm = -0.5 * (resid * resid / s2e + torch.log(s2e) + _LOG2PI)
        lmax = log_norm.max()
        lmax = torch.where(torch.isfinite(lmax), lmax, torch.zeros_like(lmax))
        wns = wn * torch.exp(log_norm - lmax)
        # raw-scale Z floor (likModulatorNMFPower.m:55), folded into Zi
        Z0 = torch.clamp_min(wns.sum(), tiny)
        lZ_raw = lmax + torch.log(Z0)
        lZk = torch.clamp_min(lZ_raw, log_floor)
        Zi = torch.exp(lZ_raw - lZk) / Z0
        rs = resid / s2e
        dlZ_z = Zi * ((wns * rs)[:, None] * a).sum(0)
        dmu_g = (xn - mu_g) / s2_g
        dlZ_g = Zi * (wns[:, None] * dmu_g).sum(0)
        d2_z = Zi * (wns[:, None] * (a * a) * (rs * rs - 1.0 / s2e)[:, None]).sum(0) \
            - dlZ_z * dlZ_z
        d2_g = Zi * (wns[:, None] * (dmu_g * dmu_g - 1.0 / s2_g)).sum(0) - dlZ_g * dlZ_g
        dlZ = torch.cat([dlZ_z, dlZ_g])
        d2lZ = torch.cat([d2_z, d2_g])
        # ---- damped ADF site update from zero incoming sites --------------
        denom = 1.0 + d2lZ * HPH
        tt = torch.clamp_min(damp * (-d2lZ / denom), 0.0)
        tn = damp * ((dlZ - fmu * d2lZ) / denom)
        # unobserved steps: zero sites (a no-op update) and lZ = 0
        tt = torch.where(observed[t], tt, torch.zeros_like(tt))
        tn = torch.where(observed[t], tn, torch.zeros_like(tn))
        lZ[t] = torch.where(observed[t], lZk, torch.zeros_like(lZk))
        tts[t] = tt
        tns[t] = tn
        m, P = _update(tt, tn, fmu, HPH, PH, mp, Pp)
        ms[t] = m
        Ps[t] = P
    return ms, Ps, lZ, tts, tns


_DLINK = {  # d link / dx from x and link(x)
    "softplus": lambda x, lk: torch.sigmoid(x),
    "exp": lambda x, lk: lk,
}


class PlainMatch:
    """One step's cubature moment match written out for its reverse, the
    piece that the plain versions of K7 and K8 share.

    The constructor re-derives the totals of the sigma points at the cavity
    (fmu, var) (C,) and the first two derivatives of log Z, ``dl`` and
    ``d2``; ``vjp`` runs them backwards.  The max shift is a constant (it
    carries no gradient), clamps pass the cotangent where they do not bind
    (torch's ``>=`` rule): sqrt(max(s2_g, 0)), the 'sq' amplitude's floor
    ``sq_floor``, the raw-scale Z floor and Z's tiny floor.
    """

    def __init__(self, y_t, fmu, var, W, xi, wn, sn2, *, link, sq, sq_floor, log_floor):
        D = W.shape[0]
        self.D, self.W, self.xi, self.xi2 = D, W, xi, xi * xi
        self.link, self.sq, self.sq_floor, self.log_floor = link, sq, sq_floor, log_floor
        self.tiny = tiny = torch.finfo(fmu.dtype).tiny
        self.mu_z, mu_g, self.s2_z, self.s2_g = fmu[:D], fmu[D:], var[:D], var[D:]
        self.sd = sd = torch.sqrt(torch.clamp_min(self.s2_g, 0.0))
        self.xn = xn = mu_g + sd * xi  # (S, N)
        self.lk = lk = LINKS[link](xn)
        self.a_raw = a_raw = lk @ W.T  # (S, D)
        self.a = a = torch.sqrt(torch.clamp_min(a_raw, sq_floor)) if sq else a_raw
        self.a2 = a2 = a * a
        s2e = sn2 + a2 @ self.s2_z
        resid = y_t - a @ self.mu_z
        self.inv = inv = 1.0 / s2e
        self.rs = rs = resid * inv
        log_norm = -0.5 * (resid * rs + torch.log(s2e) + _LOG2PI)
        lmax = log_norm.max()
        lmax = torch.where(torch.isfinite(lmax), lmax, torch.zeros_like(lmax))
        self.wns = wns = wn * torch.exp(log_norm - lmax)
        self.Z = Z = wns.sum()
        self.c2 = c2 = rs * rs - inv
        self.X1, self.X2 = wns @ xi, wns @ self.xi2  # the unit point's weighted moments
        self.is2 = is2 = 1.0 / self.s2_g
        self.rg = rg = sd * is2
        self.S1 = S1 = torch.cat([(wns * rs) @ a, rg * self.X1])
        self.S2 = S2 = torch.cat([(wns * c2) @ a2, rg * rg * self.X2 - is2 * Z])
        self.Z0 = Z0 = torch.clamp_min(Z, tiny)
        self.lZ_raw = lZ_raw = lmax + torch.log(Z0)
        lZk = torch.clamp_min(lZ_raw, log_floor)
        self.e = e = torch.exp(lZ_raw - lZk)
        self.Zi = Zi = e / Z0
        self.dl = dl = Zi * S1
        self.d2 = Zi * S2 - dl * dl

    def vjp(self, g_dl, g_d2, g_lZ_t, g_fmu, g_var, gW, gsn2):
        """The cotangents of dl, d2 and of the step's lZ (a number or a 0-d
        tensor) added to those of fmu and var (C,), W's (float64) and
        sn2's: returns (g_fmu, g_var, gW, gsn2)."""
        D, W, xi, xi2 = self.D, self.W, self.xi, self.xi2
        sd, is2, rg, Z, Zi = self.sd, self.is2, self.rg, self.Z, self.Zi
        a, a2, rs, inv, c2, wns = self.a, self.a2, self.rs, self.inv, self.c2, self.wns
        # ---- the derivatives of log Z from the totals ----------------------
        g_dl = g_dl - 2.0 * self.dl * g_d2
        g_S1, g_S2 = g_dl * Zi, g_d2 * Zi
        g_Zi = (g_d2 * self.S2 + g_dl * self.S1).sum()
        gA1, gA2 = g_S1[:D], g_S2[:D]
        gX1, gX2 = g_S1[D:] * rg, g_S2[D:] * rg * rg
        g_rg = g_S1[D:] * self.X1 + 2.0 * rg * g_S2[D:] * self.X2
        g_is2 = g_rg * sd - g_S2[D:] * Z
        g_sd = g_rg * is2
        g_Z = -(is2 * g_S2[D:]).sum()
        g_var = torch.cat([g_var[:D], g_var[D:] - g_is2 * is2 * is2])
        # lZk = max(lmax + log Z0, log_floor), Zi = exp(lZ_raw - lZk) / Z0
        Z0, e = self.Z0, self.e
        g_e = g_Zi / Z0
        g_Z0 = -g_Zi * Zi / Z0
        g_lZk = g_lZ_t - g_e * e
        g_raw = g_e * e + torch.where(self.lZ_raw >= self.log_floor, g_lZk,
                                      torch.zeros_like(g_lZk))
        g_Z0 = g_Z0 + g_raw / Z0
        g_Z = g_Z + torch.where(Z >= self.tiny, g_Z0, torch.zeros_like(g_Z0))
        # ---- the sigma points ----------------------------------------------
        u1, u2 = a @ gA1, a2 @ gA2
        ux = xi @ gX1 + xi2 @ gX2
        g_wns = g_Z + rs * u1 + c2 * u2 + ux
        g_rs = wns * (u1 + 2.0 * rs * u2)
        g_inv = -wns * u2
        g_ln = g_wns * wns
        g_resid = g_rs * inv - g_ln * rs
        g_s2e = 0.5 * g_ln * c2 - g_rs * rs * inv - g_inv * inv * inv
        gsn2 = gsn2 + g_s2e.sum()
        g_a = ((wns * rs)[:, None] * gA1 + 2.0 * (wns * c2)[:, None] * gA2 * a
               - g_resid[:, None] * self.mu_z + 2.0 * g_s2e[:, None] * a * self.s2_z)
        if self.sq:
            g_a = torch.where(self.a_raw >= self.sq_floor, g_a * 0.5 / a, torch.zeros_like(g_a))
        gW = gW + g_a.T @ self.lk
        g_xn = (g_a @ W) * _DLINK[self.link](self.xn, self.lk)
        g_sd = g_sd + (g_xn * xi).sum(0)
        g_var = g_var + torch.cat([g_s2e @ a2, torch.where(
            self.s2_g >= 0.0, g_sd * 0.5 / sd, torch.zeros_like(sd))])
        g_fmu = g_fmu + torch.cat([-(g_resid @ a), g_xn.sum(0)])
        return g_fmu, g_var, gW, gsn2


def fused_adf_vjp_plain(y, obs, A, Q, Pinf, H, W, xi, wn, sn2, ms, Ps, g_ms, g_Ps, g_lZ, g_tt,
                        g_tn, *, damp, link, variant, z_floor):
    """K7 reference: the vector-Jacobian product of ``fused_adf_plain``.

    Inputs as ``fused_adf_plain``'s, its filtered ms (T, C, bs), Ps (T, C,
    bs, bs), and the cotangents of its five outputs (None = zero).  Returns
    the cotangents of A, Q, Pinf (C, bs, bs), H (C, bs), W (D, N) and sn2 ().

    A reverse loop over t = T-1 .. 0 in the kernel's step order: step t is
    re-derived from the stored (ms, Ps)[t-1] ((0, Pinf) at t = 0), then run
    backwards through the update, the damped site, the derivatives of log Z,
    the cubature totals and their sigma points (one pass over the points,
    ``PlainMatch``), the observation and the prediction.  The max shift is a
    constant (it carries no gradient), clamps pass the cotangent where they
    do not bind (torch's ``>=`` rule), and the parameter cotangents are
    summed over T in float64 whatever the dtype.
    """
    T = y.shape[0]
    C, bs = H.shape
    dt_, dev = A.dtype, A.device
    f64 = dict(dtype=torch.float64, device=dev)
    At = A.transpose(-1, -2)
    log_floor = float(torch.log(torch.tensor(z_floor, dtype=dt_)))
    observed = (obs > 0).tolist()
    gA = torch.zeros((C, bs, bs), **f64)
    gQ = torch.zeros((C, bs, bs), **f64)
    gH = torch.zeros((C, bs), **f64)
    gW = torch.zeros(W.shape, **f64)
    gsn2 = torch.zeros((), **f64)
    m_bar = torch.zeros((C, bs), dtype=dt_, device=dev)
    P_bar = torch.zeros((C, bs, bs), dtype=dt_, device=dev)
    zero_C = torch.zeros((C,), dtype=dt_, device=dev)
    for t in range(T - 1, -1, -1):
        if g_ms is not None:
            m_bar = m_bar + g_ms[t]
        if g_Ps is not None:
            P_bar = P_bar + g_Ps[t]
        m0, P0 = (ms[t - 1], Ps[t - 1]) if t > 0 else (torch.zeros_like(m_bar), Pinf)
        AP = A @ P0
        mp, Pp = (A @ m0[..., None])[..., 0], AP @ At + Q
        fmu, PH, var = _observe(H, mp, Pp)
        g_tt_t = zero_C if g_tt is None else g_tt[t]
        g_tn_t = zero_C if g_tn is None else g_tn[t]
        if observed[t]:
            # ---- re-derive the moment match of step t (as fused_adf_plain) --
            mm = PlainMatch(y[t], fmu, var, W, xi, wn, sn2, link=link, sq=variant == "sq",
                            sq_floor=1e-12, log_floor=log_floor)
            dl, d2 = mm.dl, mm.d2
            denom = 1.0 + d2 * var
            r = -d2 / denom
            tt = torch.clamp_min(damp * r, 0.0)
            tn = damp * ((dl - fmu * d2) / denom)
        else:
            tt = tn = zero_C
        # ---- the update m = mp - PH v, P = Pp - w PH PH' ------------------
        z = tt * var + 1.0
        v = (tt * fmu - tn) / z
        w = tt / z
        g_mp, g_Pp = m_bar, P_bar
        g_PH = -v[:, None] * m_bar - w[:, None] * ((P_bar + P_bar.transpose(-1, -2))
                                                   @ PH[..., None])[..., 0]
        g_v = -(PH * m_bar).sum(-1)
        g_w = -(PH[:, :, None] * P_bar * PH[:, None, :]).sum((-1, -2))
        g_z = -(g_v * v + g_w * w) / z
        g_fmu = g_v * tt / z
        g_var = g_z * tt
        if observed[t]:
            # ---- the site, from zero incoming sites -------------------------
            g_tt_all = g_tt_t + (g_v * fmu + g_w) / z + g_z * var
            g_tn_all = g_tn_t - g_v / z
            g_r = torch.where(damp * r >= 0.0, damp * g_tt_all, torch.zeros_like(r))
            g_den = -(g_tn_all * tn + g_r * r) / denom
            g_dl = damp * g_tn_all / denom
            g_d2 = -damp * g_tn_all * fmu / denom - g_r / denom + g_den * var
            g_fmu = g_fmu - damp * g_tn_all * d2 / denom
            g_var = g_var + g_den * d2
            g_fmu, g_var, gW, gsn2 = mm.vjp(g_dl, g_d2, 0.0 if g_lZ is None else g_lZ[t],
                                            g_fmu, g_var, gW, gsn2)
        # ---- the observation fmu = H mp, PH = Pp H, var = H' PH -----------
        g_PH = g_PH + g_var[:, None] * H
        g_Hs = g_var[:, None] * PH + g_fmu[:, None] * mp + (g_PH[:, None, :] @ Pp)[:, 0]
        g_mp = g_mp + g_fmu[:, None] * H
        g_Pp = g_Pp + g_PH[:, :, None] * H[:, None, :]
        # ---- the prediction mp = A m, Pp = (A P) A' + Q -------------------
        g_AP = g_Pp @ A
        g_As = g_Pp.transpose(-1, -2) @ AP + g_AP @ P0.transpose(-1, -2) \
            + g_mp[:, :, None] * m0[:, None, :]
        gA += g_As
        gQ += g_Pp
        gH += g_Hs
        m_bar = (At @ g_mp[..., None])[..., 0]
        P_bar = At @ g_AP
    return gA.to(dt_), gQ.to(dt_), P_bar, gH.to(dt_), gW.to(dt_), gsn2.to(dt_)


def fused_adf_mb_plain(y, obs, A, Q, Pinf, H, W, xi, wn, sn2, *, damp, link, variant,
                       z_floor, s_chunk=0):
    """K4 reference: ADF forward sweep from zero sites over BF files at once.

    y, obs (T, BF) (obs 0/1); A, Q, Pinf (BF, C, bs, bs); H (BF, C, bs);
    W (BF, D, N); xi (S, N), wn (S,) shared unit sigma points; sn2 (BF,).
    Returns ms (T, BF, C, bs), Ps (T, BF, C, bs, bs), lZ (T, BF), ttau, tnu
    (T, BF, C).

    The sigma points are taken ``s_chunk`` at a time (0 = all S in one chunk)
    with the online max-rescale of ``_adf_kernel_mb``: per chunk the chunk max
    ``mc`` (0 where not finite), ``m_new = max(m_run, mc)``, the chunk's sums
    at shift ``m_new``, and the totals so far rescaled by exp(m_run - m_new)
    (the first chunk is not rescaled).  Per file the result equals
    ``fused_adf_plain`` up to that reordering.
    """
    T, BF = y.shape
    _, C, bs = H.shape
    D = W.shape[1]
    S = wn.shape[0]
    sc = s_chunk if s_chunk else S
    dt_, dev = A.dtype, A.device
    lk_fn = LINKS[link]
    At = A.transpose(-1, -2)
    Wt = W.transpose(-1, -2)  # (BF, N, D)
    tiny = torch.finfo(dt_).tiny
    log_floor = float(torch.log(torch.tensor(z_floor, dtype=dt_)))
    observed = obs > 0
    m = torch.zeros((BF, C, bs), dtype=dt_, device=dev)
    P = Pinf
    ms = torch.empty((T, BF, C, bs), dtype=dt_, device=dev)
    Ps = torch.empty((T, BF, C, bs, bs), dtype=dt_, device=dev)
    lZ = torch.empty((T, BF), dtype=dt_, device=dev)
    tts = torch.empty((T, BF, C), dtype=dt_, device=dev)
    tns = torch.empty((T, BF, C), dtype=dt_, device=dev)
    for t in range(T):
        mp, Pp = _predict(A, At, Q, m, P)
        fmu, PH, HPH = _observe(H, mp, Pp)  # (BF, C)
        mu_z, mu_g = fmu[:, None, :D], fmu[:, None, D:]  # (BF, 1, .)
        s2_z, s2_g = HPH[:, None, :D], HPH[:, None, D:]
        sd_g = torch.sqrt(torch.clamp_min(s2_g, 0.0))
        m_run = tot = None
        for c0 in range(0, S, sc):
            xn = mu_g + sd_g * xi[c0:c0 + sc]  # (BF, sc, N)
            a = lk_fn(xn) @ Wt  # (BF, sc, D)
            if variant == "sq":
                a = torch.sqrt(torch.clamp_min(a, 1e-12))
            s2e = sn2[:, None] + (a * a * s2_z).sum(-1)  # (BF, sc)
            resid = y[t][:, None] - (a * mu_z).sum(-1)
            log_norm = -0.5 * (resid * resid / s2e + torch.log(s2e) + _LOG2PI)
            mc = log_norm.amax(dim=1)
            mc = torch.where(torch.isfinite(mc), mc, torch.zeros_like(mc))
            m_new = mc if m_run is None else torch.maximum(m_run, mc)
            wns = wn[c0:c0 + sc] * torch.exp(log_norm - m_new[:, None])
            rs = resid / s2e
            dmu_g = (xn - mu_g) / s2_g
            part = (  # Z (BF,), A1, A2 (BF, D), G1, G2 (BF, N)
                wns.sum(1),
                ((wns * rs)[..., None] * a).sum(1),
                (wns[..., None] * (a * a) * (rs * rs - 1.0 / s2e)[..., None]).sum(1),
                (wns[..., None] * dmu_g).sum(1),
                (wns[..., None] * (dmu_g * dmu_g - 1.0 / s2_g)).sum(1),
            )
            if tot is None:
                tot = part
            else:
                al = torch.exp(m_run - m_new)
                tot = tuple(x * al.reshape((BF,) + (1,) * (x.dim() - 1)) + xc
                            for x, xc in zip(tot, part))
            m_run = m_new
        Z, A1, A2, G1, G2 = tot
        # raw-scale Z floor (likModulatorNMFPower.m:55), folded into Zi
        Z0 = torch.clamp_min(Z, tiny)
        lZ_raw = m_run + torch.log(Z0)
        lZk = torch.clamp_min(lZ_raw, log_floor)
        Zi = (torch.exp(lZ_raw - lZk) / Z0)[:, None]
        dlZ_z, dlZ_g = Zi * A1, Zi * G1
        dlZ = torch.cat([dlZ_z, dlZ_g], dim=1)
        d2lZ = torch.cat([Zi * A2 - dlZ_z * dlZ_z, Zi * G2 - dlZ_g * dlZ_g], dim=1)
        # ---- damped ADF site update from zero incoming sites --------------
        denom = 1.0 + d2lZ * HPH
        tt = torch.clamp_min(damp * (-d2lZ / denom), 0.0)
        tn = damp * ((dlZ - fmu * d2lZ) / denom)
        # unobserved steps: zero sites (a no-op update) and lZ = 0
        seen = observed[t][:, None]
        tt = torch.where(seen, tt, torch.zeros_like(tt))
        tn = torch.where(seen, tn, torch.zeros_like(tn))
        lZ[t] = torch.where(observed[t], lZk, torch.zeros_like(lZk))
        tts[t] = tt
        tns[t] = tn
        m, P = _update(tt, tn, fmu, HPH, PH, mp, Pp)
        ms[t] = m
        Ps[t] = P
    return ms, Ps, lZ, tts, tns


def shifted_partial(log_norm, wn, terms):
    """What one lane (or any partition of the sigma points) holds after its
    points, as ``csrc/adf_step.cuh`` keeps it: the partition's own shift and
    its K totals at that shift.

    log_norm, wn (P,), terms (P, K) -> (shift (), totals (K,)).  The shift is
    the largest log-normaliser under the kernel's plain ``>`` (a NaN never
    wins: it poisons the totals instead); an empty partition has shift -inf
    and zero totals; a point at -inf adds exactly zero.
    """
    neg_inf = torch.full((), -math.inf, dtype=terms.dtype, device=terms.device)
    if log_norm.numel() == 0:
        return neg_inf, torch.zeros(terms.shape[1:], dtype=terms.dtype, device=terms.device)
    shift = torch.where(torch.isnan(log_norm), neg_inf, log_norm).amax()
    e = torch.where(log_norm == -math.inf, torch.zeros_like(log_norm),
                    torch.exp(log_norm - shift))
    return shift, ((wn * e)[:, None] * terms).sum(0)


def merge_shifted_partials(shifts, totals):
    """The kernels' merge of partial totals kept under different shifts
    (``merge_partials`` in ``csrc/adf_step.cuh``): shifts (P,), totals (P, K)
    -> (shift (), totals (K,)) with

        m = max_p shifts[p],   out = sum_p totals[p] * scale_p   (in order p),
        scale_p = 0 where shifts[p] = -inf (an empty partial, whatever m is),
                  exp(shifts[p] - m) otherwise.

    Totals are signed (cubature weights may be negative): they are rescaled,
    never logged.  The returned shift is m, or 0 where m is not finite (the
    rule applied once, to the merged shift); every consumer forms ratios
    ``out[k] / out[0]`` and ``shift + log(out[0])``, in which m cancels.
    """
    m = shifts.amax()
    scale = torch.where(shifts == -math.inf, torch.zeros_like(shifts), torch.exp(shifts - m))
    out = torch.zeros_like(totals[0])
    for p in range(totals.shape[0]):
        out = out + totals[p] * scale[p]
    return torch.where(torch.isfinite(m), m, torch.zeros_like(m)), out


def fused_resite_plain(mp: MomentParams, y, mask, mu, var, ttau, tnu, W, sn2, *, frac, damp,
                       chunk=4096):
    """K9 reference, and the re-site on CPU tensors and in ``FusedResite``'s
    backward: EP site re-matching at the smoothed cavity for all T at once (ref
    gf_ep_modulator_nmf.m:240-267).

    y, mask (T,); mu, var (T, C) smoothed observable marginals; ttau, tnu
    (T, C) the sites.  Returns the damped, clamped sites (T, C) and lZ (T,)
    (0 where mask is False).  A channel whose cavity variance is not positive
    keeps its site and enters the match at (0, 1).  ``moments_chunked`` takes
    ``chunk`` sites at a time."""
    v_cav_raw = 1.0 / (1.0 / var - frac * ttau)
    ok = (v_cav_raw > 0.0) & mask[:, None]
    v_cav = torch.where(ok, v_cav_raw, torch.ones_like(v_cav_raw))
    m_cav = torch.where(ok, v_cav_raw * (mu / var - frac * tnu), torch.zeros_like(v_cav_raw))

    lZ, dlZ, d2lZ = moments_chunked(mp, sn2, y, m_cav, v_cav, W, frac, chunk=chunk)
    lZ = torch.where(mask, lZ, torch.zeros_like(lZ))

    denom = 1.0 + d2lZ * v_cav
    ttau_prop = (1.0 - damp * frac) * ttau + damp * (-d2lZ / denom)
    tnu_prop = (1.0 - damp * frac) * tnu + damp * ((dlZ - m_cav * d2lZ) / denom)
    return (torch.clamp_min(torch.where(ok, ttau_prop, ttau), 0.0),
            torch.where(ok, tnu_prop, tnu), lZ)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _on_cpu(*xs) -> bool:
    """True for CPU tensors; False for CUDA tensors; raises otherwise."""
    devs = {x.device for x in xs}
    if len(devs) != 1:
        raise ValueError(f"fused kernels need all tensors on one device, got {devs}")
    dev = devs.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"fused kernels run on CPU (plain) or CUDA tensors, not {dev}")
    dtypes = {x.dtype for x in xs}
    if len(dtypes) != 1 or dtypes.pop() not in (torch.float32, torch.float64):
        raise TypeError(f"fused kernels need one dtype, float32 or float64; got {dtypes}")
    return False


def _ptr(x: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(x.data_ptr())


def _launch(name: str, fn, *args, device) -> None:
    """Call a C entry point on the current stream of ``device``; raise on
    any CUDA error it reports."""
    with torch.cuda.device(device):
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        rc = fn(*args, stream)
    if rc != 0:
        why = _LAUNCH_CODES.get(rc, "CUDA error")
        raise RuntimeError(f"{name}: kernel launch failed (code {rc}: {why})")


def _check_shapes(name: str, bs, T: int, **expected) -> None:
    """The kernels index raw pointers: refuse a block size they do not
    instantiate (None: a kernel without one), an empty signal, or any tensor
    whose shape disagrees."""
    if bs is not None and not 1 <= bs <= MAX_BLOCK:
        raise ValueError(f"fused kernels support block sizes 1..{MAX_BLOCK}, got {bs}")
    if T < 1:
        raise ValueError(f"{name} needs T >= 1")
    for arg, (x, shape) in expected.items():
        if tuple(x.shape) != shape:
            raise ValueError(f"{name}: {arg} has shape {tuple(x.shape)}, expected {shape}")


def blocked_launch_shape(T: int, C: int, chunk=None) -> dict:
    """How K1 and K2 launch for T steps of C channels: steps a chunk, chunks,
    (chunk, channel) threads of passes 1 and 3, and launches a pass."""
    L = chunk or chunk_length(T, C)
    nc = -(-T // L)
    return {"chunk": L, "chunks": nc, "threads": nc * C, "passes": 3 if nc > 1 else 1}


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """Contiguous and on a 16-byte boundary (the kernels move rows of m and
    P as 16-byte vectors); a view that starts elsewhere is copied."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


# Values a (chunk, channel) pair takes in the scratch, by block size: the
# widths of ``kalman_scratch_values`` in csrc/fused_kalman.cuh.
_FWD_TOTAL = lambda bs: 3 * bs * bs + 2 * bs  # At, b, Cm, eta, J
_BWD_TOTAL = lambda bs: 2 * bs * bs + bs  # E, g, L
_CARRY = lambda bs: bs + bs * bs  # m, P


def _scratch(values: int, slots: int, C: int, like: torch.Tensor):
    """Totals or carries of ``slots`` chunks, laid out (chunk, value, C);
    None when there is one chunk."""
    if slots < 1:
        return None
    return torch.empty((slots, values, C), dtype=like.dtype, device=like.device)


def _by_dtype(lib, entry: str, dtype):
    """The C entry point of one dtype: ``<entry>_f32`` or ``<entry>_f64``."""
    return getattr(lib, entry + ("_f64" if dtype == torch.float64 else "_f32"))


def _opt_ptr(x) -> ctypes.c_void_p:
    return ctypes.c_void_p(None) if x is None else _ptr(x)


def fused_fwd(ttau, tnu, A, Q, Pinf, H, *, _chunk=None):
    """K1: forward filter with fixed sites (see ``fused_fwd_plain``).  On the
    card: three blocked passes over chunks of ``chunk_length(T, C)`` steps
    (``fused_fwd_blocked_plain`` is their plain version), one count a call.
    ``_chunk`` is for the timing tools and the card tests: another chunk
    length."""
    if _on_cpu(ttau, tnu, A, Q, Pinf, H):
        return fused_fwd_plain(ttau, tnu, A, Q, Pinf, H)
    with launched(fused_fwd, "nsgp.K1"):
        from nsgp_tpu_torch.ops import _build

        T, C = ttau.shape
        bs = H.shape[1]
        mat = (C, bs, bs)
        _check_shapes("fused_fwd", bs, T, tnu=(tnu, (T, C)), A=(A, mat), Q=(Q, mat),
                      Pinf=(Pinf, mat), H=(H, (C, bs)))
        args = [_aligned(x) for x in (ttau, tnu, A, Q, Pinf, H)]
        ms = torch.empty((T, C, bs), dtype=A.dtype, device=A.device)
        Ps = torch.empty((T, C, bs, bs), dtype=A.dtype, device=A.device)
        lib = _build.library()
        shape = blocked_launch_shape(T, C, _chunk)
        tot = _scratch(_FWD_TOTAL(bs), shape["chunks"] - 1, C, A)
        carry = _scratch(_CARRY(bs), shape["chunks"] - 1, C, A)
        _launch("fused_fwd", _by_dtype(lib, "nsgp_fused_fwd", A.dtype), bs, *map(_ptr, args),
                _ptr(ms), _ptr(Ps), _opt_ptr(tot), _opt_ptr(carry), T, C, shape["chunk"],
                device=A.device)
        return ms, Ps


def fused_bwd(ms, Ps, A, Q, pad, *, _chunk=None):
    """K2: RTS smoother over a filtered trajectory (see ``fused_bwd_plain``).
    On the card: three blocked passes (``fused_bwd_blocked_plain``), one
    count a call; ``_chunk`` as in ``fused_fwd``."""
    if _on_cpu(ms, Ps, A, Q, pad):
        return fused_bwd_plain(ms, Ps, A, Q, pad)
    with launched(fused_bwd, "nsgp.K2"):
        from nsgp_tpu_torch.ops import _build

        T, C, bs = ms.shape
        mat = (C, bs, bs)
        _check_shapes("fused_bwd", bs, T, Ps=(Ps, (T, C, bs, bs)), A=(A, mat), Q=(Q, mat),
                      pad=(pad, (C, bs)))
        args = [_aligned(x) for x in (ms, Ps, A, Q, pad)]
        sm = torch.empty_like(args[0])
        sP = torch.empty_like(args[1])
        lib = _build.library()
        shape = blocked_launch_shape(T, C, _chunk)
        tot = _scratch(_BWD_TOTAL(bs), shape["chunks"] - 1, C, A)
        carry = _scratch(_CARRY(bs), shape["chunks"] - 1, C, A)
        _launch("fused_bwd", _by_dtype(lib, "nsgp_fused_bwd", A.dtype), bs, *map(_ptr, args),
                _ptr(sm), _ptr(sP), _opt_ptr(tot), _opt_ptr(carry), T, C, shape["chunk"],
                device=A.device)
        return sm, sP


def _check_adf(name: str, lib, C: int, D: int, N: int, S: int, link, variant):
    """What both ADF kernels refuse: an unknown link, a channel count that
    is not D + N, more subbands or modulators than a warp's lanes can take
    (within that width a channel a thread and the shared layout always fit)."""
    if link not in LINKS or variant not in ("amp", "sq"):
        raise ValueError(f"unsupported link/variant {link!r}/{variant!r}")
    if C != D + N:
        raise ValueError(f"{name} needs C = D + N channels, got C={C}, D={D}, N={N}")
    width = lib.nsgp_adf_max_width()
    if not (1 <= D <= width and 1 <= N <= width and S >= 1):
        raise ValueError(f"{name} takes at most {width} subbands and {width} modulators "
                         f"and needs a sigma point: D={D}, N={N}, S={S}")


def adf_launch_shape(S: int) -> dict:
    """How the ADF kernels launch for S sigma points: threads a CTA and CTAs
    a file (the cluster size).  Needs the built library."""
    from nsgp_tpu_torch.ops import _build

    lib = _build.library()
    return {"threads": lib.nsgp_adf_threads(), "cluster": lib.nsgp_adf_cluster(S)}


def fused_adf(y, obs, A, Q, Pinf, H, W, xi, wn, sn2, *, damp, link, variant, z_floor):
    """K3: ADF forward sweep with in-step cubature moments (see
    ``fused_adf_plain``)."""
    if _on_cpu(y, obs, A, Q, Pinf, H, W, xi, wn, sn2):
        return fused_adf_plain(y, obs, A, Q, Pinf, H, W, xi, wn, sn2, damp=damp,
                               link=link, variant=variant, z_floor=z_floor)
    with launched(fused_adf, "nsgp.K3"):
        from nsgp_tpu_torch.ops import _build

        T = y.shape[0]
        C, bs = H.shape
        D, N = W.shape
        S = wn.shape[0]
        mat = (C, bs, bs)
        _check_shapes("fused_adf", bs, T, y=(y, (T,)), obs=(obs, (T,)), A=(A, mat), Q=(Q, mat),
                      Pinf=(Pinf, mat), H=(H, (C, bs)), W=(W, (D, N)), xi=(xi, (S, N)),
                      wn=(wn, (S,)), sn2=(sn2.reshape(-1), (1,)))
        lib = _build.library()
        _check_adf("fused_adf", lib, C, D, N, S, link, variant)
        args = [x.contiguous() for x in (y, obs, A, Q, Pinf, H, W, xi, wn, sn2.reshape(1))]
        dt_, dev = A.dtype, A.device
        ms = torch.empty((T, C, bs), dtype=dt_, device=dev)
        Ps = torch.empty((T, C, bs, bs), dtype=dt_, device=dev)
        lZ = torch.empty((T,), dtype=dt_, device=dev)
        tt = torch.empty((T, C), dtype=dt_, device=dev)
        tn = torch.empty((T, C), dtype=dt_, device=dev)
        log_floor = float(torch.log(torch.tensor(z_floor, dtype=dt_)))
        _launch("fused_adf", _by_dtype(lib, "nsgp_fused_adf", dt_), bs, *map(_ptr, args),
                float(damp), log_floor, T, D, N, S, int(link == "exp"), int(variant == "sq"),
                _ptr(ms), _ptr(Ps), _ptr(lZ), _ptr(tt), _ptr(tn), device=dev)
        return ms, Ps, lZ, tt, tn


def fused_adf_vjp(y, obs, A, Q, Pinf, H, W, xi, wn, sn2, ms, Ps, g_ms, g_Ps, g_lZ, g_tt, g_tn,
                  *, damp, link, variant, z_floor, _lib=None, _cycles=None):
    """K7: the reverse of K3's sweep (see ``fused_adf_vjp_plain``): K3's
    filtered ms, Ps and the cotangents of its outputs (None = zero) to those
    of A, Q, Pinf, H, W and sn2.  Two launches of one kernel: a pre-pass over
    all steps that writes a record of each, then the reverse walk on one CTA.
    The record holds every sigma point's forward values where the walk can
    read them and they take at most ``VJP_STASH_BYTES``; such calls count in
    ``fused_adf_vjp.stashed``.  ``_lib`` / ``_cycles`` are for
    ``tools/probe_adf_cycles.py --kernel vjp``: a library built with the
    clock probe and the int64 it fills."""
    outs = [x for x in (g_ms, g_Ps, g_lZ, g_tt, g_tn) if x is not None]
    if _on_cpu(y, obs, A, Q, Pinf, H, W, xi, wn, sn2, ms, Ps, *outs):
        return fused_adf_vjp_plain(y, obs, A, Q, Pinf, H, W, xi, wn, sn2, ms, Ps, g_ms, g_Ps,
                                   g_lZ, g_tt, g_tn, damp=damp, link=link, variant=variant,
                                   z_floor=z_floor)
    with launched(fused_adf_vjp, "nsgp.K7"):
        from nsgp_tpu_torch.ops import _build

        T = y.shape[0]
        C, bs = H.shape
        D, N = W.shape
        S = wn.shape[0]
        mat = (C, bs, bs)
        _check_shapes("fused_adf_vjp", bs, T, y=(y, (T,)), obs=(obs, (T,)), A=(A, mat), Q=(Q, mat),
                      Pinf=(Pinf, mat), H=(H, (C, bs)), W=(W, (D, N)), xi=(xi, (S, N)),
                      wn=(wn, (S,)), sn2=(sn2.reshape(-1), (1,)), ms=(ms, (T, C, bs)),
                      Ps=(Ps, (T, C, bs, bs)),
                      **{k: (x, s) for k, x, s in (("g_ms", g_ms, (T, C, bs)),
                                                   ("g_Ps", g_Ps, (T, C, bs, bs)),
                                                   ("g_lZ", g_lZ, (T,)), ("g_tt", g_tt, (T, C)),
                                                   ("g_tn", g_tn, (T, C))) if x is not None})
        lib = _lib or _build.library()
        _check_adf("fused_adf_vjp", lib, C, D, N, S, link, variant)
        args = [x.contiguous() for x in (y, obs, A, Q, Pinf, H, W, xi, wn, sn2.reshape(1), ms, Ps)]
        cots = [None if x is None else x.contiguous() for x in (g_ms, g_Ps, g_lZ, g_tt, g_tn)]
        dt_, dev = A.dtype, A.device
        grads = [torch.empty(s, dtype=dt_, device=dev)
                 for s in (mat, mat, mat, (C, bs), (D, N), ())]
        # the float64 sums of the parameters' cotangents, where shared memory cannot hold them
        scratch = torch.empty((lib.nsgp_adf_vjp_scratch(D, N, bs),), dtype=torch.float64,
                              device=dev)
        item = torch.finfo(dt_).bits // 8
        per_step = lib.nsgp_adf_vjp_record(D, N, S, bs, item, 0)
        with_points = lib.nsgp_adf_vjp_record(D, N, S, bs, item, 1)
        stash = with_points > 0 and T * (with_points - per_step) * item <= VJP_STASH_BYTES
        record = torch.empty((T * (with_points if stash else per_step),), dtype=dt_, device=dev)
        log_floor = float(torch.log(torch.tensor(z_floor, dtype=dt_)))
        _launch("fused_adf_vjp", _by_dtype(lib, "nsgp_fused_adf_vjp", dt_), bs, *map(_ptr, args),
                *map(_opt_ptr, cots), float(damp), log_floor, T, D, N, S, int(link == "exp"),
                int(variant == "sq"), *map(_ptr, grads), _ptr(scratch), _ptr(record), int(stash),
                _opt_ptr(_cycles), device=dev)
        fused_adf_vjp.stashed += int(stash)
        return tuple(grads)


class FusedADF(torch.autograd.Function):
    """K3 forward, K7 backward: EP sweep 1 differentiable in A, Q, Pinf, H, W
    and sn2 (y, obs, xi and wn get none), once (K7 has no adjoint of its
    own).  On CPU tensors the two plain twins.  ``kw`` holds damp, link,
    variant and z_floor."""

    @staticmethod
    def forward(ctx, y, obs, A, Q, Pinf, H, W, xi, wn, sn2, kw):
        outs = fused_adf(y, obs, A, Q, Pinf, H, W, xi, wn, sn2, **kw)
        ctx.save_for_backward(y, obs, A, Q, Pinf, H, W, xi, wn, sn2, outs[0], outs[1])
        ctx.kw = kw
        ctx.set_materialize_grads(False)
        return outs

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_ms, g_Ps, g_lZ, g_tt, g_tn):
        saved = ctx.saved_tensors
        gA, gQ, gPinf, gH, gW, gsn2 = fused_adf_vjp(*saved, g_ms, g_Ps, g_lZ, g_tt, g_tn,
                                                    **ctx.kw)
        return None, None, gA, gQ, gPinf, gH, gW, None, None, gsn2.reshape(saved[9].shape), None


def fused_adf_mb(y, obs, A, Q, Pinf, H, W, xi, wn, sn2, *, damp, link, variant, z_floor,
                 s_chunk=0, _lib=None, _cycles=None):
    """K4: ADF forward sweep over BF files in one launch, a cluster of CTAs a
    file (see ``fused_adf_mb_plain``).  ``s_chunk`` keeps its meaning for the
    plain version (0 = one shift over all S, > 0 = streamed).  The kernel
    evaluates each point once in either mode: every lane keeps its totals
    under its own running shift and the partials are merged once per step
    (``merge_shifted_partials``), so on the card the value changes nothing.
    ``_lib`` / ``_cycles`` are for ``tools/probe_adf_cycles.py``: a library
    built with the clock probe and the six int64 it fills."""
    if _on_cpu(y, obs, A, Q, Pinf, H, W, xi, wn, sn2):
        return fused_adf_mb_plain(y, obs, A, Q, Pinf, H, W, xi, wn, sn2, damp=damp,
                                  link=link, variant=variant, z_floor=z_floor,
                                  s_chunk=s_chunk)
    with launched(fused_adf_mb, "nsgp.K4"):
        from nsgp_tpu_torch.ops import _build

        T, BF = y.shape
        _, C, bs = H.shape
        _, D, N = W.shape
        S = wn.shape[0]
        mat = (BF, C, bs, bs)
        _check_shapes("fused_adf_mb", bs, T, obs=(obs, (T, BF)), A=(A, mat), Q=(Q, mat),
                      Pinf=(Pinf, mat), H=(H, (BF, C, bs)), W=(W, (BF, D, N)), xi=(xi, (S, N)),
                      wn=(wn, (S,)), sn2=(sn2, (BF,)))
        if BF < 1 or s_chunk < 0:
            raise ValueError(f"fused_adf_mb needs BF >= 1 and s_chunk >= 0, got {BF}, {s_chunk}")
        lib = _lib or _build.library()
        _check_adf("fused_adf_mb", lib, C, D, N, S, link, variant)
        args = [x.contiguous() for x in (y, obs, A, Q, Pinf, H, W, xi, wn, sn2)]
        dt_, dev = A.dtype, A.device
        ms = torch.empty((T, BF, C, bs), dtype=dt_, device=dev)
        Ps = torch.empty((T, BF, C, bs, bs), dtype=dt_, device=dev)
        lZ = torch.empty((T, BF), dtype=dt_, device=dev)
        tt = torch.empty((T, BF, C), dtype=dt_, device=dev)
        tn = torch.empty((T, BF, C), dtype=dt_, device=dev)
        log_floor = float(torch.log(torch.tensor(z_floor, dtype=dt_)))
        cycles = ctypes.c_void_p(None) if _cycles is None else _ptr(_cycles)
        _launch("fused_adf_mb", _by_dtype(lib, "nsgp_fused_adf_mb", dt_), bs, *map(_ptr, args),
                float(damp), log_floor, T, BF, D, N, S, int(link == "exp"),
                int(variant == "sq"), _ptr(ms), _ptr(Ps), _ptr(lZ), _ptr(tt), _ptr(tn), cycles,
                device=dev)
        return ms, Ps, lZ, tt, tn


class FusedResite(torch.autograd.Function):
    """K9 forward; backward the VJP of its plain twin, recomputed at the
    saved inputs (K9 has no adjoint of its own): differentiable in mu, var,
    ttau, tnu, W and sn2 (y and mask get none), once.  ``kw`` holds mp, frac,
    damp and the twin's ``chunk``."""

    @staticmethod
    def forward(ctx, y, mask, mu, var, ttau, tnu, W, sn2, kw):
        mp, frac, damp, _ = kw
        ctx.save_for_backward(y, mask, mu, var, ttau, tnu, W, sn2)
        ctx.kw = kw
        return _resite_launch(mp, y, mask, mu, var, ttau, tnu, W, sn2, frac=frac, damp=damp)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_tt, g_tn, g_lZ):
        y, mask, *xs = ctx.saved_tensors
        mp, frac, damp, chunk = ctx.kw
        need = ctx.needs_input_grad[2:8]
        with torch.enable_grad():
            leaves = [x.detach().requires_grad_(n) for x, n in zip(xs, need)]
            outs = fused_resite_plain(mp, y, mask, *leaves, frac=frac, damp=damp, chunk=chunk)
            outs, gs = zip(*[(o, g) for o, g in zip(outs, (g_tt, g_tn, g_lZ)) if o.requires_grad])
            grads = iter(torch.autograd.grad(outs, [x for x in leaves if x.requires_grad], gs,
                                             allow_unused=True))
        return (None, None, *(next(grads) if n else None for n in need), None)


def fused_resite(mp: MomentParams, y, mask, mu, var, ttau, tnu, W, sn2, *, frac, damp,
                 chunk=4096):
    """K9: the all-T EP re-site in one launch, a warp a site (see
    ``fused_resite_plain``), through ``FusedResite``, whose backward
    recomputes the plain twin.  ``chunk`` is read only where the twin runs:
    on CPU tensors and in that backward.  'sq' amplitudes take
    sqrt(max(a, tiny)) with tiny the dtype's smallest normal."""
    if mask.device != mu.device or mask.dtype != torch.bool:
        raise ValueError(f"fused_resite needs a bool mask on {mu.device}, got {mask.dtype} "
                         f"on {mask.device}")
    if _on_cpu(y, mu, var, ttau, tnu, W):
        return fused_resite_plain(mp, y, mask, mu, var, ttau, tnu, W, sn2, frac=frac, damp=damp,
                                  chunk=chunk)
    with launched(fused_resite, "nsgp.K9"):
        sn2 = torch.as_tensor(sn2, dtype=mu.dtype, device=mu.device)
        return FusedResite.apply(y, mask, mu, var, ttau, tnu, W, sn2, (mp, frac, damp, chunk))


def _resite_launch(mp: MomentParams, y, mask, mu, var, ttau, tnu, W, sn2, *, frac, damp):
    """K9's launch on CUDA tensors (``FusedResite.forward``)."""
    from nsgp_tpu_torch.ops import _build

    T, C = mu.shape
    D, N = W.shape
    dt_, dev = mu.dtype, mu.device
    wn, xi = sigma_points(mp, dt_, dev)
    S = wn.shape[0]
    if (mp.D, mp.N) != (D, N):
        raise ValueError(f"fused_resite: W is {D} x {N}, the moment rule {mp.D} x {mp.N}")
    _check_shapes("fused_resite", None, T, y=(y, (T,)), mask=(mask, (T,)), var=(var, (T, C)),
                  ttau=(ttau, (T, C)), tnu=(tnu, (T, C)))
    lib = _build.library()
    _check_adf("fused_resite", lib, C, D, N, S, mp.link, mp.variant)
    pep = None
    if mp.use_pep_const:  # the constant ``moments`` adds to lZ, as it forms it
        pep_const = (2.0 * math.pi * sn2) ** (0.5 * (1.0 - frac)) * frac ** (-0.5)
        pep = torch.log(torch.as_tensor(pep_const, dtype=dt_, device=dev)).reshape(1)
    args = [x.contiguous() for x in (y, mask, mu, var, ttau, tnu, W, xi, wn, sn2.reshape(1))]
    tt_out = torch.empty((T, C), dtype=dt_, device=dev)
    tn_out = torch.empty((T, C), dtype=dt_, device=dev)
    lZ = torch.empty((T,), dtype=dt_, device=dev)
    _launch("fused_resite", _by_dtype(lib, "nsgp_fused_resite", dt_), *map(_ptr, args),
            _opt_ptr(pep), float(frac), float(damp), _log_floor(mp.z_floor, dt_),
            torch.finfo(dt_).tiny, T, D, N, S, int(mp.link == "exp"),
            int(mp.variant == "sq"), _ptr(tt_out), _ptr(tn_out), _ptr(lZ), device=dev)
    return tt_out, tn_out, lZ


WRAPPERS = (fused_fwd, fused_bwd, fused_adf, fused_adf_mb, fused_adf_vjp, fused_resite)


def reset_launches() -> None:
    for fn in WRAPPERS:
        fn.launches = 0
    fused_adf_vjp.stashed = 0


reset_launches()


# ---------------------------------------------------------------------------
# Pass-level entry points (counterparts of the pallas_kalman functions)
# ---------------------------------------------------------------------------


def _flat(ms, Ps):
    T = ms.shape[0]
    return ms.reshape(T, -1), Ps.reshape(T, -1)


def check_stationary(ssm: BlockSSM) -> None:
    """Raise unless Q = Pinf - A Pinf A' (any leading axes): the kernels
    start from (0, Pinf) and rely on one prediction leaving it unchanged.
    Tolerance relative to max |Pinf|: 1e-5 in float32, 1e-10 in float64."""
    with torch.no_grad(), span("nsgp.check_stationary"):
        gap = ssm.Q - (ssm.Pinf - ssm.A @ ssm.Pinf @ ssm.A.transpose(-1, -2))
        rel = float(gap.abs().max() / ssm.Pinf.abs().max())
    tol = 1e-10 if ssm.A.dtype == torch.float64 else 1e-5
    if not rel <= tol:
        raise ValueError(
            f"the fused passes need the stationary discretization Q = Pinf - A Pinf A' "
            f"(max gap {rel:.3e} of max|Pinf|, tolerance {tol:g}); build the model with "
            f"discretization='stationary'")


def smoother_fused(ssm: BlockSSM, ms, Ps):
    """RTS pass over a (T, C, bs) / (T, C, bs, bs) filtered trajectory;
    returns C-major flat (T, C*bs), (T, C*bs*bs) (``smoother_pallas_bmajor``)."""
    pad = torch.diagonal(ssm.pad_eye, dim1=-2, dim2=-1)
    return _flat(*fused_bwd(ms, Ps, ssm.A, ssm.Q, pad))


def filter_smoother_fused(ssm: BlockSSM, sites: Sites):
    """Fixed-site filter + RTS smoother (``filter_smoother_pallas``).
    Returns C-major flat smoothed (ms (T, C*bs), Ps (T, C*bs*bs))."""
    check_stationary(ssm)
    ms, Ps = fused_fwd(sites.ttau, sites.tnu, ssm.A, ssm.Q, ssm.Pinf, ssm.H)
    return smoother_fused(ssm, ms, Ps)


def adf_filter_fused(mp: MomentParams, ssm: BlockSSM, W, sn2, y, mask, damp: float):
    """ADF sweep from zero sites (``adf_filter_pallas``), differentiable in
    the SSM, W and sn2 through ``FusedADF`` (K3, and K7 for the gradient).
    Returns filtered (ms (T, C, bs), Ps (T, C, bs, bs)), lZ (T,), Sites
    (T, C)."""
    check_stationary(ssm)
    dt_, dev = ssm.A.dtype, ssm.A.device
    wn, xi = sigma_points(mp, dt_, dev)
    ms, Ps, lZ, tt, tn = FusedADF.apply(
        torch.nan_to_num(y).to(dt_), mask.to(dt_), ssm.A, ssm.Q, ssm.Pinf, ssm.H,
        W.to(dt_), xi, wn, torch.as_tensor(sn2, dtype=dt_, device=dev),
        dict(damp=damp, link=mp.link, variant=mp.variant, z_floor=mp.z_floor),
    )
    return ms, Ps, lZ, Sites(tt, tn)


def adf_filter_fused_mb(mp: MomentParams, ssmB: BlockSSM, WB, sn2B, yB, maskB, damp: float,
                        s_chunk: int = 0):
    """ADF sweep from zero sites over BF files (``adf_filter_pallas_mb``).

    ``ssmB`` has leaves (BF, C, ...); WB (BF, D, N); sn2B (BF,); yB, maskB
    (T, BF).  Returns filtered (ms (T, BF, C, bs), Ps (T, BF, C, bs, bs)),
    lZ (T, BF), Sites (T, BF, C)."""
    check_stationary(ssmB)
    dt_, dev = ssmB.A.dtype, ssmB.A.device
    wn, xi = sigma_points(mp, dt_, dev)
    ms, Ps, lZ, tt, tn = fused_adf_mb(
        torch.nan_to_num(yB).to(dt_), maskB.to(dt_), ssmB.A, ssmB.Q, ssmB.Pinf, ssmB.H,
        WB.to(dt_), xi, wn, torch.as_tensor(sn2B, dtype=dt_, device=dev),
        damp=damp, link=mp.link, variant=mp.variant, z_floor=mp.z_floor, s_chunk=s_chunk,
    )
    return ms, Ps, lZ, Sites(tt, tn)
