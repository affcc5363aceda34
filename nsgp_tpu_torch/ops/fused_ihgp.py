"""IHGP's sequential passes: CUDA kernels and their plain twins.

Counterparts of the two scans that ``nsgp_tpu/inference/ihgp.py`` compiles
into single device loops under ``jax.jit`` (not of Pallas kernels: JAX's IHGP
reaches none), and of the transposed scan that ``jax.grad`` derives from the
first for ``ihgp_energy``:

    fused_ihgp_adf      (K5)  the steady ADF sweep, one    <- ihgp.py:402, the scan of
                              launch a forward pass            _steady_filter_seq
    fused_ihgp_smooth   (K6)  the steady RTS smoother of   <- ihgp.py:658, the scan of
                              the sequential form              _steady_smoother
    fused_ihgp_adf_vjp  (K8)  K5's sweep in reverse: the   <- the transpose of the
                              cotangents of its outputs       scan at ihgp.py:402
                              to its parameters'

(``csrc/fused_ihgp_adf.cuh``, whose moment match is K3's step,
``csrc/adf_step.cuh``, under a steady-table recursion;
``csrc/fused_ihgp_smooth.cuh``; ``csrc/fused_ihgp_adf_vjp.cuh``.)
``FusedIHGPADF`` binds K5 and K8 as one ``torch.autograd.Function``.  As in
``ops/fused_kalman.py`` each wrapper does one of two things: on CPU tensors
it runs its plain version (``*_plain``, a loop over T), on CUDA tensors it
launches its kernel or raises; it counts its launches in
``<wrapper>.launches`` inside a profiler span ``nsgp.K<n>``
(``utils.trace.launched``).  The grid lookup of the steady tables lives here,
beside the sweep that needs it on both sides.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from nsgp_tpu_torch.ops.fused_kalman import (PlainMatch, _by_dtype, _check_adf, _check_shapes,
                                             _launch, _on_cpu, _opt_ptr, _ptr)
from nsgp_tpu_torch.ops.moments import MomentParams, _log_floor, moments, sigma_points
from nsgp_tpu_torch.utils.trace import launched


class Lookup(NamedTuple):
    """The grid constants of ``lookup_idx``, in the tables' dtype."""

    lo: torch.Tensor
    hi: torch.Tensor
    span: torch.Tensor  # hi - lo
    shift: torch.Tensor
    G: int


def lookup_consts(log_r: torch.Tensor) -> Lookup:
    """The constants of the log10 noise grid ``log_r`` (G,)."""
    G = log_r.shape[0]
    lo, hi = log_r[0], log_r[-1]
    step = (hi - lo) / (G - 1)
    rho = 10.0**step
    shift = torch.log10((1.0 + rho) / 2.0) / step
    return Lookup(lo, hi, hi - lo, shift, G)


def lookup_idx(lk: Lookup, ttau: torch.Tensor) -> torch.Tensor:
    """Grid index for effective noise R = 1/ttau.

    ttau <= 0 maps to the top of the grid (R -> inf: pure prediction), the
    reference's R=inf branch (:285-289).  The nearest neighbour in LINEAR r,
    as the reference's min(abs(r - R)) (:237): on the log-uniform grid the
    linear midpoint sits at a constant fractional index ``shift`` above i.
    The 1e-300 floor is 0 in float32, as in JAX.  K5 rounds each operation
    in this order (one ulp flips an index).
    """
    logR = -torch.log10(torch.clamp_min(ttau, 1e-300))
    logR = torch.where(ttau > 0.0, logR, lk.hi)
    x = (logR - lk.lo) / lk.span * (lk.G - 1)
    # int64 for indexing: JAX's int32 holds the same values, |x| < 2**20
    return torch.clamp(torch.floor(x - lk.shift).long() + 1, 0, lk.G - 1)


def smoother_elems(A, Gn, ms, idx):
    """(G_k, c_k = mf_k - G_k A mf_k) of every step, and mf (T, C, bs), from
    filtered means ms (T, C*bs), grid indices idx (T, C), A (C, bs, bs) and
    the smoother gains Gn (C, G, bs, bs)."""
    C, bs = A.shape[0], A.shape[-1]
    car = torch.arange(C, device=ms.device)
    mf = ms.reshape(-1, C, bs)
    G = Gn[car, idx]  # (T, C, bs, bs)
    c = mf - (G @ (A @ mf[..., None]))[..., 0]
    return G, c, mf


# ---------------------------------------------------------------------------
# Plain PyTorch versions (CPU path; reference for the kernels on the card)
# ---------------------------------------------------------------------------


def fused_ihgp_adf_plain(y, obs, match, ttau, tnu, A, H, first, tab, lk: Lookup, W, sn2, *,
                         mp: MomentParams, damp: float):
    """K5 reference: the sequential steady filter with interleaved ADF
    matching (ref ihgp_ep_modulator_nmf.m:233-310).

    y (T,) observations; obs (T,) bool observed; match (T,) bool the steps
    to re-match (all on the ADF sweep, the last only on later sweeps, :251);
    ttau, tnu (T, C) incoming sites; A (C, bs, bs); H (C, bs); first (C,
    bs+1) the Pinf row [Pinf h, h'Pinf h]; tab (C, G, bs+1) the table rows
    [Ph, h'Ph]; W (D, N); sn2 () the likelihood's noise.  The moment match
    uses the steady predictive marginal h'Ph looked up at the previous
    step's site (the reference's R(n, k-1) convention); the first step uses
    Pinf.  Returns ms (T, C*bs), idx (T, C), lZ (T,), ttau, tnu (T, C).

    The per-step branch of JAX's scan (``lax.cond`` on observed & matched)
    is a Python ``if`` on masks taken to the host once a call.  The sites of
    the steps that are not re-matched are known before the loop, so their
    lookups and table rows are taken for all T at once (elementwise: the
    values of one step at a time); the loop does the lookups of the
    re-matched steps.  Autograd runs through it (``ihgp_energy``).
    """
    C, bs = H.shape
    car = torch.arange(C, device=A.device)
    HA = (H[:, None, :] @ A)[:, 0]  # (C, bs): fmu = h' A m
    steps = obs.tolist()
    do = (obs & match).tolist()
    zero = torch.zeros((), dtype=A.dtype, device=A.device)
    ys, ttaus, tnus = y.unbind(0), ttau.unbind(0), tnu.unbind(0)
    if not all(do):
        # the fixed sites: tt = ttau; idx of the step from tt_eff, and the
        # next step's row from tt itself (the same index where observed)
        idx_fix = lookup_idx(lk, torch.where(obs[:, None], ttau, torch.zeros_like(ttau)))
        idx_next = torch.where(obs[:, None], idx_fix, lookup_idx(lk, ttau))
        idx_fix, rows_next = idx_fix.unbind(0), tab[car, idx_next].unbind(0)

    m = torch.zeros_like(H)
    row = first
    ms, idxs, lZs, tts, tns = [], [], [], [], []
    for k in range(len(steps)):
        Ph_prev, varp = row[:, :bs], row[:, bs]
        fmu = (HA * m).sum(-1)
        if do[k]:
            lZk, dlZ, d2lZ = moments(mp, sn2, ys[k], fmu, varp, W, 1.0)
            denom = 1.0 + d2lZ * varp
            tt = (1.0 - damp) * ttaus[k] + damp * (-d2lZ / denom)
            tn = (1.0 - damp) * tnus[k] + damp * ((dlZ - fmu * d2lZ) / denom)
            tt = torch.clamp_min(tt, 0.0)
            idx = lookup_idx(lk, tt)  # observed: tt_eff is tt
            tt_eff = tt
            row = tab[car, idx]
        else:
            lZk, tt, tn, idx = zero, ttaus[k], tnus[k], idx_fix[k]
            tt_eff = tt if steps[k] else torch.zeros_like(tt)
            row = rows_next[k]
        # REFERENCE GAIN CONVENTION: K = PP(R_{k-1}) h / (h'PP(R_{k-1})h + R_k)
        # (:296); in z-form m <- A m + Ph_prev (tnu - ttau fmu) / (ttau hPh_prev + 1),
        # with the hard pure-prediction branch at ttau == 0.
        z = tt_eff * varp + 1.0
        gain = torch.where(tt_eff > 0.0, (tn - tt_eff * fmu) / z, zero)
        m = (A @ m[..., None])[..., 0] + Ph_prev * gain[:, None]
        ms.append(m.reshape(-1))
        idxs.append(idx)
        lZs.append(lZk)
        tts.append(tt)
        tns.append(tn)
    return torch.stack(ms), torch.stack(idxs), torch.stack(lZs), torch.stack(tts), torch.stack(tns)


def fused_ihgp_adf_vjp_plain(y, obs, match, ttau, tnu, A, H, first, tab, lk: Lookup, W, sn2,
                             ms, idx, tt, g_ms, g_lZ, g_tt, g_tn, *, mp: MomentParams,
                             damp: float):
    """K8 reference: the vector-Jacobian product of ``fused_ihgp_adf_plain``.

    Inputs as ``fused_ihgp_adf_plain``'s, its outputs ms (T, C*bs), idx and
    ttau (T, C), and the cotangents of ms, lZ, ttau and tnu (None = zero).
    Returns the cotangents of A (C, bs, bs), H (C, bs), first (C, bs+1), tab
    (C, G, bs+1), W (D, N) and sn2 ().  y, the flags, the incoming sites and
    the grid get none; the lookup is piecewise constant.

    A reverse loop over t = T-1 .. 0 in the kernel's step order.  Step t is
    re-derived from the stored ms[t-1] (0 at t = 0) and the row it read:
    ``first`` at t = 0, else tab[c, id_next(t-1)] with id_next = idx where
    observed, else lookup(ttau), both from the forward's outputs (a lookup
    re-derived from a recomputed site can flip in float32).  Then backwards:
    the mean update m = A m_prev + Ph gain, the gain (the pure-prediction
    branch at tt_eff == 0 passes nothing), the damped and clamped site, the
    moment match (``PlainMatch``), fmu = (h'A) m_prev.  The row's cotangent
    is scattered into the row the step read.  Parameter sums in float64
    whatever the dtype.
    """
    T = y.shape[0]
    C, bs = H.shape
    dt_, dev = A.dtype, A.device
    f64 = dict(dtype=torch.float64, device=dev)
    wn, xi = sigma_points(mp, dt_, dev)
    log_floor = _log_floor(mp.z_floor, dt_)
    car = torch.arange(C, device=dev)
    At = A.transpose(-1, -2)
    HA = (H[:, None, :] @ A)[:, 0]
    seen = obs.tolist()
    do = (obs & match).tolist()
    id_next = torch.where(obs[:, None], idx, lookup_idx(lk, tt))  # the row step t + 1 read
    ms = ms.reshape(T, C, bs)
    gA = torch.zeros((C, bs, bs), **f64)
    gHA = torch.zeros((C, bs), **f64)
    gtab = torch.zeros(tab.shape, **f64)
    gW = torch.zeros(W.shape, **f64)
    gsn2 = torch.zeros((), **f64)
    m_bar = torch.zeros((C, bs), dtype=dt_, device=dev)
    zero_C = torch.zeros((C,), dtype=dt_, device=dev)
    omd = 1.0 - damp
    for t in range(T - 1, -1, -1):
        if g_ms is not None:
            m_bar = m_bar + g_ms[t].reshape(C, bs)
        if t > 0:
            m0, row = ms[t - 1], tab[car, id_next[t - 1]]
        else:
            m0, row = torch.zeros_like(m_bar), first
        Ph, var = row[:, :bs], row[:, bs]
        fmu = (HA * m0).sum(-1)
        if do[t]:
            # ---- re-derive the moment match and the site (as the forward) ----
            mm = PlainMatch(y[t], fmu, var, W, xi, wn, sn2, link=mp.link,
                            sq=mp.variant == "sq", sq_floor=torch.finfo(dt_).tiny,
                            log_floor=log_floor)
            dl, d2 = mm.dl, mm.d2
            denom = 1.0 + d2 * var
            r = -d2 / denom
            q = (dl - fmu * d2) / denom
            pre = omd * ttau[t] + damp * r
            tt_t = torch.clamp_min(pre, 0.0)
            tn_t = omd * tnu[t] + damp * q
        else:
            tt_t, tn_t = ttau[t], tnu[t]
        te = tt_t if seen[t] else zero_C
        z = te * var + 1.0
        pos = te > 0.0
        gain = torch.where(pos, (tn_t - te * fmu) / z, zero_C)
        # ---- the mean update m = A m0 + Ph gain, backwards ----------------
        g_gain = torch.where(pos, (Ph * m_bar).sum(-1), zero_C)
        g_Ph = gain[:, None] * m_bar
        gA += m_bar[:, :, None] * m0[:, None, :]
        m0_bar = (At @ m_bar[..., None])[..., 0]
        # ---- the gain (tn - te fmu) / (te var + 1) --------------------------
        g_num = g_gain / z
        g_z = -g_gain * gain / z
        g_tn_all = g_num if g_tn is None else g_num + g_tn[t]
        g_tt_all = zero_C if g_tt is None else g_tt[t]
        if seen[t]:
            g_tt_all = g_tt_all + (-g_num * fmu + g_z * var)
        g_fmu = -g_num * te
        g_var = g_z * te
        if do[t]:
            # ---- the damped site, clamped at 0 --------------------------------
            g_r = torch.where(pre >= 0.0, damp * g_tt_all, zero_C)
            g_q = damp * g_tn_all
            g_den = -(g_q * q + g_r * r) / denom
            g_dl = g_q / denom
            g_d2 = -g_q * fmu / denom - g_r / denom + g_den * var
            g_fmu = g_fmu - g_q * d2 / denom
            g_var = g_var + g_den * d2
            g_fmu, g_var, gW, gsn2 = mm.vjp(g_dl, g_d2, 0.0 if g_lZ is None else g_lZ[t],
                                            g_fmu, g_var, gW, gsn2)
        # ---- fmu = (h'A) m0; the row's cotangent to the row the step read -----
        gHA += g_fmu[:, None] * m0
        m0_bar = m0_bar + g_fmu[:, None] * HA
        g_row = torch.cat([g_Ph, g_var[:, None]], dim=-1)
        if t > 0:
            gtab.index_put_((car, id_next[t - 1]), g_row.double(), accumulate=True)
        else:
            g_first = g_row
        m_bar = m0_bar
    # HA = H'A: its cotangent to A's and H's
    gA += H.double()[:, :, None] * gHA[:, None, :]
    gH = (A.double() @ gHA[..., None])[..., 0]
    return gA.to(dt_), gH.to(dt_), g_first, gtab.to(dt_), gW.to(dt_), gsn2.to(dt_)


def fused_ihgp_smooth_plain(ms, idx, A, Gn):
    """K6 reference: the steady RTS smoother on filtered means ms (T, C*bs),
    ms_k = G_k ms_{k+1} + (mf_k - G_k A mf_k) with G_k = Gn[c, idx_k] (ref
    :373-442, means only); the last row is mf_{T-1}.  idx (T, C), A (C, bs,
    bs), Gn (C, G, bs, bs).  Returns (T, C*bs)."""
    T = ms.shape[0]
    G, c, mf = smoother_elems(A, Gn, ms, idx)
    Gs, cs = G.unbind(0), c.unbind(0)
    m = mf[-1]
    out = [ms[-1]]
    for k in range(T - 2, -1, -1):
        m = (Gs[k] @ m[..., None])[..., 0] + cs[k]
        out.append(m.reshape(-1))
    return torch.stack(out[::-1])


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _check_flags(name: str, dev, T: int, **flags) -> None:
    for arg, x in flags.items():
        if x.dtype != torch.bool or x.device != dev or tuple(x.shape) != (T,):
            raise ValueError(f"{name}: {arg} must be a bool ({T},) tensor on {dev}, got "
                             f"{x.dtype} {tuple(x.shape)} on {x.device}")


def fused_ihgp_adf(y, obs, match, ttau, tnu, A, H, first, tab, lk: Lookup, W, sn2, *,
                   mp: MomentParams, damp: float):
    """K5: the steady ADF sweep in one launch (see ``fused_ihgp_adf_plain``);
    the moment match is K3's, at the sigma points of ``mp``.  Returns ms
    (T, C*bs), idx (T, C) int64, lZ (T,), ttau, tnu (T, C)."""
    if _on_cpu(y, ttau, tnu, A, H, first, tab, W, sn2):
        return fused_ihgp_adf_plain(y, obs, match, ttau, tnu, A, H, first, tab, lk, W, sn2,
                                    mp=mp, damp=damp)
    with launched(fused_ihgp_adf, "nsgp.K5"):
        from nsgp_tpu_torch.ops import _build

        T = y.shape[0]
        C, bs = H.shape
        G = tab.shape[1]
        D, N = mp.D, mp.N
        dt_, dev = A.dtype, A.device
        wn, xi = sigma_points(mp, dt_, dev)
        S = wn.shape[0]
        _check_shapes("fused_ihgp_adf", bs, T, y=(y, (T,)), ttau=(ttau, (T, C)), tnu=(tnu, (T, C)),
                      A=(A, (C, bs, bs)), first=(first, (C, bs + 1)), tab=(tab, (C, G, bs + 1)),
                      W=(W, (D, N)), sn2=(sn2.reshape(-1), (1,)))
        _check_flags("fused_ihgp_adf", dev, T, obs=obs, match=match)
        lib = _build.library()
        _check_adf("fused_ihgp_adf", lib, C, D, N, S, mp.link, mp.variant)
        lk4 = torch.stack([lk.lo, lk.hi, lk.span, lk.shift]).to(dev, dt_)
        args = [x.contiguous() for x in (y, (obs & match).to(dt_), obs.to(dt_), ttau, tnu, A, H,
                                         first, tab, lk4, W, xi, wn, sn2.reshape(1))]
        ms = torch.empty((T, C * bs), dtype=dt_, device=dev)
        idx = torch.empty((T, C), dtype=torch.int32, device=dev)
        lZ = torch.empty((T,), dtype=dt_, device=dev)
        tt = torch.empty((T, C), dtype=dt_, device=dev)
        tn = torch.empty((T, C), dtype=dt_, device=dev)
        damp = float(damp)
        # 'sq': moments takes sqrt(a) unclamped; the kernel's floor is the
        # smallest normal number (a == 0 gives 1e-19 in float32, not a NaN)
        _launch("fused_ihgp_adf", _by_dtype(lib, "nsgp_fused_ihgp_adf", dt_), bs, *map(_ptr, args),
                damp, 1.0 - damp, _log_floor(mp.z_floor, dt_), torch.finfo(dt_).tiny, T, D, N, S,
                G, int(mp.link == "exp"), int(mp.variant == "sq"), _ptr(ms), _ptr(idx), _ptr(lZ),
                _ptr(tt), _ptr(tn), device=dev)
        return ms, idx.long(), lZ, tt, tn


def fused_ihgp_adf_vjp(y, obs, match, ttau, tnu, A, H, first, tab, lk: Lookup, W, sn2, ms, idx,
                       tt, g_ms, g_lZ, g_tt, g_tn, *, mp: MomentParams, damp: float):
    """K8: the reverse of K5's sweep (see ``fused_ihgp_adf_vjp_plain``): K5's
    inputs, its outputs ms, idx and ttau and the cotangents of ms, lZ, ttau
    and tnu (None = zero) to those of A, H, first, tab, W and sn2.  One
    launch, one CTA."""
    cots = (g_ms, g_lZ, g_tt, g_tn)
    given = [x for x in cots if x is not None]
    if _on_cpu(y, ttau, tnu, A, H, first, tab, W, sn2, ms, tt, *given):
        return fused_ihgp_adf_vjp_plain(y, obs, match, ttau, tnu, A, H, first, tab, lk, W, sn2,
                                        ms, idx, tt, g_ms, g_lZ, g_tt, g_tn, mp=mp, damp=damp)
    with launched(fused_ihgp_adf_vjp, "nsgp.K8"):
        from nsgp_tpu_torch.ops import _build

        T = y.shape[0]
        C, bs = H.shape
        G = tab.shape[1]
        D, N = mp.D, mp.N
        dt_, dev = A.dtype, A.device
        wn, xi = sigma_points(mp, dt_, dev)
        S = wn.shape[0]
        _check_shapes("fused_ihgp_adf_vjp", bs, T, y=(y, (T,)), ttau=(ttau, (T, C)),
                      tnu=(tnu, (T, C)), A=(A, (C, bs, bs)), first=(first, (C, bs + 1)),
                      tab=(tab, (C, G, bs + 1)), W=(W, (D, N)), sn2=(sn2.reshape(-1), (1,)),
                      ms=(ms, (T, C * bs)), idx=(idx, (T, C)), tt=(tt, (T, C)),
                      **{k: (x, s) for k, x, s in (("g_ms", g_ms, (T, C * bs)),
                                                   ("g_lZ", g_lZ, (T,)), ("g_tt", g_tt, (T, C)),
                                                   ("g_tn", g_tn, (T, C))) if x is not None})
        _check_flags("fused_ihgp_adf_vjp", dev, T, obs=obs, match=match)
        if idx.device != dev or idx.dtype not in (torch.int32, torch.int64):
            raise ValueError(f"fused_ihgp_adf_vjp: idx must be an integer tensor on {dev}")
        lib = _build.library()
        _check_adf("fused_ihgp_adf_vjp", lib, C, D, N, S, mp.link, mp.variant)
        lk4 = torch.stack([lk.lo, lk.hi, lk.span, lk.shift]).to(dev, dt_)
        args = [x.contiguous() for x in (y, (obs & match).to(dt_), obs.to(dt_), ttau, tnu, A, H,
                                         first, tab, lk4, W, xi, wn, sn2.reshape(1), ms,
                                         idx.to(torch.int32), tt)]
        cots = [None if x is None else x.contiguous() for x in cots]
        grads = [torch.empty(s, dtype=dt_, device=dev)
                 for s in ((C, bs, bs), (C, bs), (C, bs + 1), (C, G, bs + 1), (D, N), ())]
        # the float64 sums of the cotangents, where shared memory cannot hold them
        scratch = torch.empty((lib.nsgp_ihgp_adf_vjp_scratch(D, N, bs, G),), dtype=torch.float64,
                              device=dev)
        damp = float(damp)
        _launch("fused_ihgp_adf_vjp", _by_dtype(lib, "nsgp_fused_ihgp_adf_vjp", dt_), bs,
                *map(_ptr, args), *map(_opt_ptr, cots), damp, 1.0 - damp,
                _log_floor(mp.z_floor, dt_), torch.finfo(dt_).tiny, T, D, N, S, G,
                int(mp.link == "exp"), int(mp.variant == "sq"), *map(_ptr, grads), _ptr(scratch),
                device=dev)
        return tuple(grads)


class FusedIHGPADF(torch.autograd.Function):
    """K5 forward, K8 backward: the steady ADF sweep differentiable in A, H,
    first, tab, W and sn2 (y, the flags, the incoming sites and the grid get
    none), once (K8 has no adjoint of its own).  On CPU tensors the two
    plain twins.  ``kw`` holds mp and damp."""

    @staticmethod
    def forward(ctx, y, obs, match, ttau, tnu, A, H, first, tab, lk, W, sn2, kw):
        ms, idx, lZ, tt, tn = fused_ihgp_adf(y, obs, match, ttau, tnu, A, H, first, tab, lk, W,
                                             sn2, **kw)
        ctx.save_for_backward(y, obs, match, ttau, tnu, A, H, first, tab, W, sn2, ms, idx, tt)
        ctx.lk, ctx.kw = lk, kw
        ctx.mark_non_differentiable(idx)
        ctx.set_materialize_grads(False)
        return ms, idx, lZ, tt, tn

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_ms, _g_idx, g_lZ, g_tt, g_tn):
        if any(ctx.needs_input_grad[i] for i in (0, 3, 4)):
            raise NotImplementedError("FusedIHGPADF: y and the incoming sites get no gradient")
        y, obs, match, ttau, tnu, A, H, first, tab, W, sn2, ms, idx, tt = ctx.saved_tensors
        gA, gH, gfirst, gtab, gW, gsn2 = fused_ihgp_adf_vjp(
            y, obs, match, ttau, tnu, A, H, first, tab, ctx.lk, W, sn2, ms, idx, tt, g_ms, g_lZ,
            g_tt, g_tn, **ctx.kw)
        return (None, None, None, None, None, gA, gH, gfirst, gtab, None, gW,
                gsn2.reshape(sn2.shape), None)


def fused_ihgp_adf_autograd(y, obs, match, ttau, tnu, A, H, first, tab, lk: Lookup, W, sn2, *,
                            mp: MomentParams, damp: float):
    """``fused_ihgp_adf`` under autograd, through ``FusedIHGPADF``: K5 forward
    and K8 backward on the card, their plain twins on the CPU."""
    return FusedIHGPADF.apply(y, obs, match, ttau, tnu, A, H, first, tab, lk, W, sn2,
                              dict(mp=mp, damp=damp))


def fused_ihgp_smooth(ms, idx, A, Gn):
    """K6: the steady smoother of the sequential form in one launch (see
    ``fused_ihgp_smooth_plain``)."""
    if _on_cpu(ms, A, Gn):
        return fused_ihgp_smooth_plain(ms, idx, A, Gn)
    with launched(fused_ihgp_smooth, "nsgp.K6"):
        from nsgp_tpu_torch.ops import _build

        T = ms.shape[0]
        C, bs = A.shape[0], A.shape[-1]
        G = Gn.shape[1]
        _check_shapes("fused_ihgp_smooth", bs, T, ms=(ms, (T, C * bs)), idx=(idx, (T, C)),
                      A=(A, (C, bs, bs)), Gn=(Gn, (C, G, bs, bs)))
        if idx.device != ms.device or idx.dtype not in (torch.int32, torch.int64):
            raise ValueError(f"fused_ihgp_smooth: idx must be an integer tensor on {ms.device}")
        args = [x.contiguous() for x in (ms, idx.to(torch.int32), A, Gn)]
        sm = torch.empty_like(args[0])
        lib = _build.library()
        _launch("fused_ihgp_smooth", _by_dtype(lib, "nsgp_fused_ihgp_smooth", ms.dtype), bs,
                *map(_ptr, args), _ptr(sm), T, C, G, device=ms.device)
        return sm


WRAPPERS = (fused_ihgp_adf, fused_ihgp_smooth, fused_ihgp_adf_vjp)


def reset_launches() -> None:
    for fn in WRAPPERS:
        fn.launches = 0


reset_launches()

