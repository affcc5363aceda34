"""IHGP's sequential passes: CUDA kernels and their plain twins.

Counterparts of the two scans that ``nsgp_tpu/inference/ihgp.py`` compiles
into single device loops under ``jax.jit`` (not of Pallas kernels: JAX's IHGP
reaches none):

    fused_ihgp_adf     (K5)  the steady ADF sweep, one    <- ihgp.py:402, the scan of
                             launch a forward pass            _steady_filter_seq
    fused_ihgp_smooth  (K6)  the steady RTS smoother of   <- ihgp.py:658, the scan of
                             the sequential form              _steady_smoother

(``csrc/fused_ihgp_adf.cuh``, whose moment match is K3's step,
``csrc/adf_step.cuh``, under a steady-table recursion; and
``csrc/fused_ihgp_smooth.cuh``.)  As in ``ops/fused_kalman.py`` each wrapper
does one of two things: on CPU tensors it runs its plain version
(``*_plain``, the loop over T that the engine ran before), on CUDA tensors
it launches its kernel or raises; it counts its launches in
``<wrapper>.launches``.  The grid lookup of the steady tables lives here,
beside the sweep that needs it on both sides.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from nsgp_tpu_torch.ops.fused_kalman import (_by_dtype, _check_adf, _check_shapes, _launch,
                                             _on_cpu, _ptr)
from nsgp_tpu_torch.ops.moments import MomentParams, _log_floor, moments, sigma_points


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
    fused_ihgp_adf.launches += 1
    return ms, idx.long(), lZ, tt, tn


def fused_ihgp_smooth(ms, idx, A, Gn):
    """K6: the steady smoother of the sequential form in one launch (see
    ``fused_ihgp_smooth_plain``)."""
    if _on_cpu(ms, A, Gn):
        return fused_ihgp_smooth_plain(ms, idx, A, Gn)
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
    fused_ihgp_smooth.launches += 1
    return sm


WRAPPERS = (fused_ihgp_adf, fused_ihgp_smooth)


def reset_launches() -> None:
    for fn in WRAPPERS:
        fn.launches = 0


reset_launches()

