"""Infinite-horizon (steady-state) Power-EP inference: the IHGP engine.

Port of ``nsgp_tpu/inference/ihgp.py`` (ref ihgp_ep_modulator_nmf.m /
_constraints.m).  A bank of DAREs per channel over a log-spaced grid of
effective noise levels (``build_tables``, ``ops.dare``) is cubically
upsampled to ``grid_fine`` points; at run time each channel looks up its
steady-state quantities by the effective noise R = 1/ttau, giving O(T C bs^2)
filtering with no covariance propagated:

- sweep 1 (ADF) is the sequential steady filter with interleaved moment
  matching (``_steady_filter_seq``): on the card one launch of K5
  (``ops.fused_ihgp.fused_ihgp_adf``, K3's moment match under a table
  lookup), on the CPU its plain twin, a loop over T;
- sweeps >= 2 run with fixed sites.  ``parallel=False`` repeats the
  sequential filter (re-matching only the last site, as the reference) and
  the sequential steady smoother (K6, ``fused_ihgp_smooth``, on the card);
  ``parallel=True`` runs the affine
  recursions m_k = M_k m_{k-1} + c_k and ms_k = G_k ms_{k+1} + c_k as blocked
  two-level scans (``chunk > 0``) or one-level log-depth scans
  (``chunk = 0``, ``ops.pscan.associative_scan``);
- all sites are then re-matched at the smoothed cavity at once (``_resite``).

Reference quirks copied on purpose (see the JAX module for their stories):
the filter gain mixes the previous step's table with the current step's
noise; the smoothed variance comes from the reference's inflated
Pf = PP - K ro K' (``pf_correct=0.0``); ``keep_best`` picks a sweep's
posterior by EP energy; the sequential form re-matches the last site forward
and never re-sites it backward.

``ihgp_energy``'s sweep goes through ``ops.fused_ihgp.FusedIHGPADF``: on
the card K5 forward and its hand-written adjoint K8
(``fused_ihgp_adf_vjp``) backward, one launch each a value and gradient; on
the CPU their plain twins.  The gradient of the table rows and of the Pinf
row flows on through the DARE bank under autograd, vectorised over (channel,
grid).  It builds only the forward tables: its graph never reaches the
smoother tables' ``eigh``, whose backward is NaN at the repeated zero
eigenvalues of padded dims.  Entry points follow ``utils.device``: the card
unless ``device="cpu"``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from nsgp_tpu_torch.models.gtnmf import GTNMFModel, GTNMFParams
from nsgp_tpu_torch.ops import dare as dare_mod
from nsgp_tpu_torch.ops import fused_ihgp as fih
from nsgp_tpu_torch.ops.fused_ihgp import lookup_idx as _lookup_idx
from nsgp_tpu_torch.ops.kalman import Sites
from nsgp_tpu_torch.ops.moments import moments_chunked
from nsgp_tpu_torch.ops.pscan import associative_scan
from nsgp_tpu_torch.ops.ssm import BlockSSM
from nsgp_tpu_torch.utils.device import place_inputs
from nsgp_tpu_torch.utils.precision import full_fp32
from nsgp_tpu_torch.utils.trace import span, spanned


class IHGPConfig(NamedTuple):
    ep_fraction: float = 0.5
    ep_itts: int = 3
    damping: tuple = ()
    moment_chunk: int = 8192
    grid_lo: float = -2.0  # log10 of the smallest effective noise (ref :112);
    # the grid must span the REALIZED R = lik / ttau (the experiments use -4 to -7)
    grid_hi: float = 4.0
    grid_coarse: int = 32
    grid_fine: int = 200
    unroll: int = 8  # accepted and ignored: the JAX package's lax.scan unroll
    pf_correct: float = 0.0  # log-space blend weight toward the Joseph-
    # consistent smoothed VARIANCE (0 = the reference's quirk; no experiment
    # sets it)
    keep_best: bool = False  # return the lowest-EP-energy sweep's posterior
    parallel: bool = False  # parallel-in-time passes for sweeps >= 2
    chunk: int = 1024  # blocked-scan chunk for parallel=True (0 = one level)

    def damp(self, itt: int) -> float:
        if len(self.damping) == 0:
            return 0.5
        return self.damping[min(itt, len(self.damping) - 1)]


class IHGPTables(NamedTuple):
    """Per-(channel, grid) steady-state quantities.  G = grid_fine points."""

    log_r: torch.Tensor  # (G,) log10 effective noise grid
    Ph: torch.Tensor  # (C, G, bs) predictive-covariance column P_pred h
    Gn: Optional[torch.Tensor]  # (C, G, bs, bs) steady smoother gain
    hPph: torch.Tensor  # (C, G) steady predictive marginal variance
    hPSh: Optional[torch.Tensor]  # (C, G) steady smoothed marginal variance


class IHGPResult(NamedTuple):
    Eft: torch.Tensor  # (T, C) smoothed observable means
    Varft: torch.Tensor  # (T, C) smoothed marginal variances (steady lookup)
    lZ: torch.Tensor  # (T,)
    sites: Sites
    nlZ: torch.Tensor  # (ep_itts,)
    maxdiff: torch.Tensor  # (ep_itts,) max |change| in posterior mean/variance
    # vs the previous sweep; entry 0 is inf


_INT32_MAX = 2**31 - 1


def _nearest_good(good):
    """(C, Gc) index of the nearest grid point with ``good`` on the same
    channel, ties to the lower index (JAX's argmin); 0 where none is good.
    The distance is scaled and offset by the index so that the minimum is
    unique whatever the device's argmin does with ties."""
    Gc = good.shape[-1]
    gi = torch.arange(Gc, device=good.device)
    dist = (gi[:, None] - gi[None, :]).abs()[None]  # (1, Gc, Gc)
    dist = torch.where(good[:, None, :], dist, torch.full_like(dist, _INT32_MAX))
    return torch.argmin(dist * Gc + gi, dim=-1)


def _take(x, src):
    """x (C, Gc, bs, bs) rows src (C, Gc): JAX's take_along_axis on axis 1."""
    return torch.gather(x, 1, src[..., None, None].expand(x.shape))


def build_tables(ssm: BlockSSM, cfg: IHGPConfig, smoother: bool = True) -> IHGPTables:
    """Solve the DARE bank and derive the steady-state tables.

    Ref ihgp_ep_modulator_nmf.m:104-191, vectorized over (C, grid): the
    coarse bank is solved, failed points patched from the nearest converged
    one, the DARE solution interpolated to the fine grid for the forward
    tables (Ph, hPph), the smoother tables (Gn, hPSh) derived at the COARSE
    points and then interpolated.  ``smoother=False`` leaves Gn and hPSh
    None (the energy needs only the forward tables).

    The bank runs on each channel's state balanced to unit prior variances
    (x -> x / sqrt(diag Pinf)); the tables come back in the model's
    coordinates.  A slow Matern channel's derivative states have prior
    variances up to 1e9 times below its value's, and unbalanced the
    smoother stage's solve lost that many digits (h'PS h 59% off in float32
    on the piano model's slowest subband, 1.9e-4 in float64).
    """
    d = torch.diagonal(ssm.Pinf, dim1=-2, dim2=-1)
    s = torch.sqrt(torch.where(d > 0, d, torch.ones_like(d)))  # (C, bs); padded dims 1
    ss = s[:, :, None] * s[:, None, :]
    A, Q, Pinf = ssm.A * (s[:, None, :] / s[:, :, None]), ssm.Q / ss, ssm.Pinf / ss
    H = ssm.H * s
    dt_, dev = A.dtype, A.device

    log_r_coarse = np.linspace(cfg.grid_lo, cfg.grid_hi, cfg.grid_coarse)
    log_r_fine = np.linspace(cfg.grid_lo, cfg.grid_hi, cfg.grid_fine)
    r_coarse = torch.as_tensor(10.0**log_r_coarse, dtype=dt_, device=dev)  # (Gc,)
    Wint = torch.as_tensor(dare_mod.cubic_interp_matrix(log_r_coarse, log_r_fine),
                           dtype=dt_, device=dev)  # (G, Gc)
    interp = lambda X: torch.einsum("gk,ckij->cgij", Wint, X)

    P_coarse = dare_mod.dare_filter(A[:, None], H[:, None], Q[:, None], r_coarse)  # (C, Gc, bs, bs)
    # DARE failure tolerance (ref :114-128 drops failing grid points): the
    # nearest converged point on the same channel; a fully failed channel
    # falls back to Pinf (pure-prediction steady state).
    res = dare_mod.dare_residual(P_coarse, A[:, None], H[:, None], Q[:, None], r_coarse)
    good = res < 1e-4
    P_coarse = _take(P_coarse, _nearest_good(good))
    any_good = good.any(dim=1)[:, None, None, None]
    P_coarse = torch.where(any_good, P_coarse, Pinf[:, None])

    # Forward tables: the reference interpolates the DARE solution itself
    # (:130-133) and derives the gain at run time.
    P_pred = interp(P_coarse)
    P_pred = 0.5 * (P_pred + P_pred.transpose(-1, -2))
    Ph = torch.einsum("cgij,cj->cgi", P_pred, H)  # (C, G, bs)
    hPph = torch.einsum("cgi,ci->cg", Ph, H)  # (C, G)

    ok0 = any_good[..., 0, 0]  # (C, 1)
    hPinfh = torch.einsum("ci,cij,cj->c", H, Pinf, H)[:, None]
    floor = 1e-10  # the reference takes abs() of negative variances (:493-496)
    hPph = torch.clamp_min(torch.where(ok0, hPph, hPinfh), floor)
    Ph = torch.where(any_good[..., 0], Ph, torch.zeros_like(Ph)) * s[:, None, :]
    log_r = torch.as_tensor(log_r_fine, dtype=dt_, device=dev)
    if not smoother:
        return IHGPTables(log_r=log_r, Ph=Ph, Gn=None, hPph=hPph, hPSh=None)

    Phc = torch.einsum("cgij,cj->cgi", P_coarse, H)
    sc = torch.einsum("cgi,ci->cg", Phc, H) + r_coarse[None, :]
    Kc = Phc / sc[..., None]

    def smoother_tables(kkw):
        """Gn, hPSh from the coarse filtered covariance Pf = PP - K kkw K':
        kkw = ro is the REFERENCE QUIRK (:162 ``P = PP-K*ro(j)*K'``), kkw = S
        the Joseph-consistent covariance."""
        Pfc = P_coarse - kkw[..., None, None] * Kc[..., :, None] * Kc[..., None, :]
        # smoother gain G = Pf A' (A Pf A' + Q)^{-1} (ref :165-175)
        APAQ = torch.einsum("cij,cgjk,clk->cgil", A, Pfc, A) + Q[:, None]
        APAQ = 0.5 * (APAQ + APAQ.transpose(-1, -2))
        PfA = torch.einsum("cgij,ckj->cgik", Pfc, A)  # Pf A'
        Gc = dare_mod._solve((APAQ + ssm.pad_eye[:, None]).transpose(-1, -2),
                             PfA.transpose(-1, -2)).transpose(-1, -2)
        # steady smoothed covariance: PS = G PS G' + QQ, QQ = Pf - G PP G',
        # eigen-clipped to PSD as the reference (:176-177).  eigh raises on
        # non-finite input where JAX's returns NaN: such points are fed a
        # zero matrix and get their NaN back after, so the patching below
        # drops them exactly as it does in JAX.
        QQ = Pfc - torch.einsum("cgij,cgjk,cglk->cgil", Gc, P_coarse, Gc)
        QQ = 0.5 * (QQ + QQ.transpose(-1, -2))
        finite = torch.isfinite(QQ).all(dim=-1).all(dim=-1)[..., None, None]
        lamQ, VQ = torch.linalg.eigh(torch.where(finite, QQ, torch.zeros_like(QQ)))
        QQ = torch.einsum("cgij,cgj,cgkj->cgik", VQ, torch.clamp_min(lamQ, 0.0), VQ)
        QQ = torch.where(finite, QQ, torch.full_like(QQ, float("nan")))
        PSc = dare_mod.dlyap_doubling(Gc, QQ)
        # Smoother-stage failure tolerance (ref :180-185): the doubling
        # diverges when rho(G) >= 1; patch bad points (non-finite or large
        # residual G PS G' - PS + QQ) with the nearest good one first.
        res_s = (torch.einsum("cgij,cgjk,cglk->cgil", Gc, PSc, Gc) - PSc + QQ).abs().amax(
            dim=(-1, -2)) / (1.0 + PSc.abs().amax(dim=(-1, -2)))
        good_s = torch.isfinite(res_s) & (res_s < 1e-6)
        src_s = _nearest_good(good_s)
        PSc, Gc = _take(PSc, src_s), _take(Gc, src_s)
        any_good_s = good_s.any(dim=1)[:, None, None, None]
        PSc = torch.where(any_good_s, PSc, Pinf[:, None])
        Gc = torch.where(any_good_s, Gc, torch.zeros_like(Gc))
        # interpolate the DERIVED smoother tables to the fine grid (:188-190)
        Gn = interp(Gc)
        PS = interp(PSc)
        PS = 0.5 * (PS + PS.transpose(-1, -2))
        return Gn, torch.einsum("ci,cgij,cj->cg", H, PS, H)

    # The mean path always uses the quirk's gain tables; pf_correct swaps in
    # only the (blended) Joseph-consistent smoothed variance.
    Gn, hPSh = smoother_tables(r_coarse[None, :].expand(sc.shape))
    if cfg.pf_correct:
        w = float(cfg.pf_correct)
        _, hPSh_c = smoother_tables(sc)
        hPSh = torch.exp((1.0 - w) * torch.log(torch.clamp_min(hPSh, 1e-30))
                         + w * torch.log(torch.clamp_min(hPSh_c, 1e-30)))

    # Fully failed channels: pure prediction at the prior (Gn = 0,
    # variances h' Pinf h).
    Gn = torch.where(any_good, Gn, torch.zeros_like(Gn)) * (s[:, None, :, None]
                                                            / s[:, None, None, :])
    hPSh = torch.clamp_min(torch.where(ok0, hPSh, hPinfh), floor)
    return IHGPTables(log_r=log_r, Ph=Ph, Gn=Gn, hPph=hPph, hPSh=hPSh)


def _lookup_consts(tables: IHGPTables) -> fih.Lookup:
    """The grid constants of ``_lookup_idx`` (``ops.fused_ihgp``), in the
    tables' dtype."""
    return fih.lookup_consts(tables.log_r)


def _steady_filter_seq(ssm: BlockSSM, tables: IHGPTables, y, mask, sites: Sites, mp, W, sn2,
                       damp: float, match_mask, sweep=fih.fused_ihgp_adf):
    """Sequential steady filter with interleaved ADF matching (ref
    ihgp_ep_modulator_nmf.m:233-310), through ``sweep``: K5's wrapper (the
    kernel on the card, its plain twin on the CPU) or, where autograd must
    run through it, ``fused_ihgp_adf_autograd`` (K5 forward, K8 backward).
    ``match_mask`` (T,) bool is
    all-True on the ADF sweep and last-step-only on later sweeps (:251).
    Returns (ms (T, C*bs), idx (T, C), lZ (T,), sites)."""
    H = ssm.H
    tab = torch.cat([tables.Ph, tables.hPph[..., None]], dim=-1)  # (C, G, bs+1)
    first = torch.cat([(ssm.Pinf @ H[..., None])[..., 0],
                       torch.einsum("ci,cij,cj->c", H, ssm.Pinf, H)[:, None]], dim=-1)
    ms, idx, lZ, tt, tn = sweep(y, mask, match_mask, sites.ttau, sites.tnu, ssm.A, H, first, tab,
                                _lookup_consts(tables), W, sn2, mp=mp, damp=damp)
    return ms, idx, lZ, Sites(tt, tn)


def _filter_combine(a, b):
    """Affine maps (M, c), ``a`` earlier: x -> Mb (Ma x + ca) + cb."""
    Ma, ca = a
    Mb, cb = b
    return Mb @ Ma, (Mb @ ca[..., None])[..., 0] + cb


def _smoother_combine(later, earlier):
    """The reverse scan's combine: ``later`` is the suffix over later times."""
    Ga, ca = later
    Gb, cb = earlier
    return Gb @ Ga, (Gb @ ca[..., None])[..., 0] + cb


def _steady_elems(ssm: BlockSSM, tables: IHGPTables, sites: Sites, mask):
    """Per-step scalars of the fixed-site steady recursion m_k = M_k m_{k-1}
    + c_k, M_k = (I - K_k h') A, c_k = K_k ys_k, under the reference gain
    convention: (idx (T, C) current-site index, gain_K, gain_c (T, C)) with
    K_k = Ph_prev gain_K and c_k = Ph_prev gain_c."""
    C = ssm.num_channels
    car = torch.arange(C, device=ssm.A.device)
    tt_eff = torch.where(mask[:, None], sites.ttau, torch.zeros_like(sites.ttau))
    idx = _lookup_idx(_lookup_consts(tables), tt_eff)  # (T, C)
    hPinfh = torch.einsum("ci,cij,cj->c", ssm.H, ssm.Pinf, ssm.H)
    hPh_prev = torch.cat([hPinfh[None], tables.hPph[car, idx[:-1]]], dim=0)  # (T, C)
    z = tt_eff * hPh_prev + 1.0
    gain_c = torch.where(tt_eff > 0.0, sites.tnu / z, torch.zeros_like(z))
    return idx, tt_eff / z, gain_c


def _steady_filter_blocked(ssm: BlockSSM, tables: IHGPTables, mask, sites: Sites, chunk: int):
    """Blocked two-level parallel steady filter with FIXED sites.

    The three passes of ``ops.bscan`` over the IHGP affine elements (M, c):
    pass 1 composes each chunk's total in L steps vectorised over the nc
    chunks, pass 2 prefixes the totals (``associative_scan``), pass 3
    re-walks and emits.  The elements of all steps are built once, in bulk,
    for both walks.  Returns (ms (T, C*bs), idx (T, C)).
    """
    C, bs = ssm.H.shape
    A = ssm.A
    T = mask.shape[0]
    L = int(chunk)
    idx, gain_K, gain_c = _steady_elems(ssm, tables, sites, mask)
    Pinfh = (ssm.Pinf @ ssm.H[..., None])[..., 0]
    HA = (ssm.H[:, None, :] @ A)[:, 0]
    car = torch.arange(C, device=A.device)

    pad = (-T) % L
    pz = lambda x: torch.cat([x, x.new_zeros((pad,) + x.shape[1:])], dim=0)
    idx_p, K_p, c_p = pz(idx), pz(gain_K), pz(gain_c)
    nc = idx_p.shape[0] // L
    # Ph from the previous step's lookup; global step 0 uses Pinf
    idx_prev = torch.cat([idx_p[:1], idx_p[:-1]], dim=0)
    Ph = tables.Ph[car, idx_prev]  # (Tp, C, bs)
    Ph = torch.cat([Pinfh[None], Ph[1:]], dim=0)
    K = Ph * K_p[..., None]
    M = A - K[..., :, None] * HA[:, None, :]  # (Tp, C, bs, bs)
    c = Ph * c_p[..., None]
    # (Tp, ...) -> (L, nc, ...): row i of every chunk at once
    M = M.reshape(nc, L, C, bs, bs).transpose(0, 1).unbind(0)
    c = c.reshape(nc, L, C, bs).transpose(0, 1).unbind(0)

    eye = torch.eye(bs, dtype=A.dtype, device=A.device)
    totals = (eye.expand(nc, C, bs, bs), A.new_zeros((nc, C, bs)))
    for i in range(L):
        totals = _filter_combine(totals, (M[i], c[i]))
    inc = associative_scan(_filter_combine, totals)
    carry = (torch.cat([eye.expand(1, C, bs, bs), inc[0][:-1]], dim=0),
             torch.cat([A.new_zeros((1, C, bs)), inc[1][:-1]], dim=0))
    ms = []
    for i in range(L):
        carry = _filter_combine(carry, (M[i], c[i]))
        ms.append(carry[1].reshape(nc, -1))
    return torch.stack(ms, dim=1).reshape(nc * L, -1)[:T], idx


def _steady_smoother_blocked(ssm: BlockSSM, tables: IHGPTables, ms, idx, chunk: int):
    """Blocked two-level steady smoother: ms_k = G_k ms_{k+1} + c_k.

    Reverse analogue of ``_steady_filter_blocked``; the global last step is
    (G, c) = (0, mf).  T is padded at the FRONT (the padded rows repeat the
    first index and carry zero means) so the global last step stays last.
    """
    C, bs = ssm.H.shape
    T = ms.shape[0]
    L = int(chunk)
    pad = (-T) % L
    if pad:
        ms = torch.cat([ms.new_zeros((pad, ms.shape[1])), ms], dim=0)
        idx = torch.cat([idx[:1].expand(pad, C), idx], dim=0)
    nc = ms.shape[0] // L
    G, c, mf = fih.smoother_elems(ssm.A, tables.Gn, ms, idx)
    G = torch.cat([G[:-1], torch.zeros_like(G[-1:])], dim=0)
    c = torch.cat([c[:-1], mf[-1:]], dim=0)
    G = G.reshape(nc, L, C, bs, bs).transpose(0, 1).unbind(0)
    c = c.reshape(nc, L, C, bs).transpose(0, 1).unbind(0)

    eye = torch.eye(bs, dtype=ms.dtype, device=ms.device)
    totals = (eye.expand(nc, C, bs, bs), ms.new_zeros((nc, C, bs)))
    for i in range(L - 1, -1, -1):
        totals = _smoother_combine(totals, (G[i], c[i]))
    inc = associative_scan(_smoother_combine, totals, reverse=True)
    carry = (torch.cat([inc[0][1:], eye.expand(1, C, bs, bs)], dim=0),
             torch.cat([inc[1][1:], ms.new_zeros((1, C, bs))], dim=0))
    sm = [None] * L
    for i in range(L - 1, -1, -1):
        carry = _smoother_combine(carry, (G[i], c[i]))
        sm[i] = carry[1].reshape(nc, -1)
    return torch.stack(sm, dim=1).reshape(nc * L, -1)[pad:]


def _steady_filter_parallel(ssm: BlockSSM, tables: IHGPTables, mask, sites: Sites):
    """One-level log-depth steady filter with FIXED sites (affine scan over
    per-step (T, C, bs, bs) maps: small T).  Returns (ms (T, C*bs), idx)."""
    C, bs = ssm.H.shape
    T = mask.shape[0]
    car = torch.arange(C, device=ssm.A.device)
    tt_eff = torch.where(mask[:, None], sites.ttau, torch.zeros_like(sites.ttau))
    idx = _lookup_idx(_lookup_consts(tables), tt_eff)  # (T, C)
    hPinfh = torch.einsum("ci,cij,cj->c", ssm.H, ssm.Pinf, ssm.H)
    Pinfh = (ssm.Pinf @ ssm.H[..., None])[..., 0]
    Ph_prev = torch.cat([Pinfh[None], tables.Ph[car, idx[:-1]]], dim=0)  # (T, C, bs)
    hPh_prev = torch.cat([hPinfh[None], tables.hPph[car, idx[:-1]]], dim=0)  # (T, C)
    z = tt_eff * hPh_prev + 1.0
    K = Ph_prev * (tt_eff / z)[..., None]
    on = tt_eff[..., None] > 0.0
    inv_tt = torch.where(tt_eff > 0.0, 1.0 / torch.clamp_min(tt_eff, 1e-30),
                         torch.zeros_like(tt_eff))
    c = torch.where(on, K * (sites.tnu * inv_tt)[..., None], torch.zeros_like(K))
    # M_k = (I - K_k h') A; pure prediction (M = A) where the site is off
    eye = torch.eye(bs, dtype=ssm.A.dtype, device=ssm.A.device)
    M = (eye - K[..., :, None] * ssm.H[None, :, None, :]) @ ssm.A
    M = torch.where(on[..., None], M, ssm.A.expand_as(M))
    _, ms = associative_scan(_filter_combine, (M, c))
    return ms.reshape(T, -1), idx


def _steady_smoother(ssm: BlockSSM, tables: IHGPTables, ms, idx, parallel: bool):
    """Steady RTS smoother on filtered means (T, C*bs): ms_k = G_k ms_{k+1}
    + c_k (ref :373-442, means only; variances come from the PS table).
    ``parallel`` is the one-level log-depth scan, else the sequential pass
    (K6's wrapper: the kernel on the card, its plain twin on the CPU)."""
    if not parallel:
        return fih.fused_ihgp_smooth(ms, idx, ssm.A, tables.Gn)
    T = ms.shape[0]
    G, c, mf = fih.smoother_elems(ssm.A, tables.Gn, ms, idx)
    Gp = torch.cat([G[:-1], torch.zeros_like(G[:1])], dim=0)
    cp = torch.cat([c[:-1], mf[-1:]], dim=0)
    _, sm = associative_scan(_smoother_combine, (Gp, cp), reverse=True)
    return sm.reshape(T, -1)


def _resite(mp, params: GTNMFParams, cfg: IHGPConfig, y, mask, mu, var, sites: Sites, damp,
            exclude_last: bool = False):
    """Vectorized EP re-matching at the smoothed cavity (all T at once), the
    scheme of ``ep._ep_resite`` (ref :397-437).  ``exclude_last`` mirrors the
    reference's backward loop bounds (site T is refreshed forward)."""
    if exclude_last:
        mask = mask.clone()
        mask[-1] = False
    frac = cfg.ep_fraction
    v_raw = 1.0 / (1.0 / var - frac * sites.ttau)
    ok = (v_raw > 0.0) & mask[:, None]
    v_cav = torch.where(ok, v_raw, torch.ones_like(v_raw))
    m_cav = torch.where(ok, v_raw * (mu / var - frac * sites.tnu), torch.zeros_like(v_raw))
    lZ, dlZ, d2lZ = moments_chunked(mp, params.lik, y, m_cav, v_cav, params.W, frac,
                                    chunk=cfg.moment_chunk)
    lZ = torch.where(mask, lZ, torch.zeros_like(lZ))
    denom = 1.0 + d2lZ * v_cav
    tt_p = (1.0 - damp * frac) * sites.ttau + damp * (-d2lZ / denom)
    tn_p = (1.0 - damp * frac) * sites.tnu + damp * ((dlZ - m_cav * d2lZ) / denom)
    ttau = torch.clamp_min(torch.where(ok, tt_p, sites.ttau), 0.0)
    tnu = torch.where(ok, tn_p, sites.tnu)
    return Sites(ttau, tnu), lZ


@spanned("nsgp.ihgp_infer")
def ihgp_infer(
    model: GTNMFModel,
    params: GTNMFParams,
    y: torch.Tensor,  # (T,) observations; NaNs allowed (-> missing)
    mask: Optional[torch.Tensor] = None,  # (T,) bool; default = ~isnan(y)
    config: IHGPConfig = IHGPConfig(),
    device=None,  # None = the card; "cpu" runs on the CPU
) -> IHGPResult:
    """Infinite-horizon Power-EP posterior inference.

    Equivalent call: ihgp_ep_modulator_nmf(w, t, y, ss, mom, t, ...).
    O(T C bs^2) work, table lookups instead of covariances.  Inputs move to
    ``device`` and the computation runs there in the parameters' dtype.
    """
    full_fp32()
    with span("nsgp.assemble"):
        dev, params, y, mask = place_inputs(params, y, mask, device)
        T = y.shape[0]
        ssm = model.build_ssm(params)
        C, bs = ssm.H.shape
        dt_ = ssm.A.dtype
        with span("nsgp.tables"):
            tables = build_tables(ssm, config)
    if config.pf_correct:
        # stability floor of the corrected tables (see the JAX module)
        tables = tables._replace(hPSh=torch.clamp_min(tables.hPSh, params.lik.to(dt_)))
    mp = model.moment_params()

    sites = Sites(torch.zeros((T, C), dtype=dt_, device=dev),
                  torch.zeros((T, C), dtype=dt_, device=dev))
    nlZ = torch.zeros((config.ep_itts,), dtype=dt_, device=dev)
    maxdiff = torch.full((config.ep_itts,), float("inf"), dtype=dt_, device=dev)
    lZ_final = torch.zeros((T,), dtype=dt_, device=dev)
    car = torch.arange(C, device=dev)
    # block-structured H projection of flattened means (T, C*bs) -> (T, C)
    Hm = (ssm.H[:, :, None] * torch.eye(C, dtype=dt_, device=dev)[:, None, :]).reshape(C * bs, C)
    all_steps = torch.ones((T,), dtype=torch.bool, device=dev)
    last_only = torch.zeros((T,), dtype=torch.bool, device=dev)
    last_only[-1] = True
    seq = not config.parallel
    lZ_last = torch.zeros((), dtype=dt_, device=dev)
    mu = var = best = None
    for itt in range(config.ep_itts):
        damp = config.damp(itt)
        with span("nsgp.sweep1" if itt == 0 else "nsgp.pass"):
            if itt == 0:
                ms, idx, lZ, sites = _steady_filter_seq(ssm, tables, y, mask, sites, mp,
                                                        params.W, params.lik, damp, all_steps)
                nlZ[0] = -torch.sum(lZ)
                lZ_final = lZ
                lZ_last = lZ[-1]
            elif config.parallel:
                if config.chunk:
                    ms, idx = _steady_filter_blocked(ssm, tables, mask, sites, config.chunk)
                else:
                    ms, idx = _steady_filter_parallel(ssm, tables, mask, sites)
            else:
                # later forward passes still re-match the last site (ref :251)
                ms, idx, lZ_fwd, sites = _steady_filter_seq(ssm, tables, y, mask, sites, mp,
                                                            params.W, params.lik, damp,
                                                            last_only)
                lZ_last = lZ_fwd[-1]
            if config.parallel and config.chunk:
                sm = _steady_smoother_blocked(ssm, tables, ms, idx, config.chunk)
            else:
                sm = _steady_smoother(ssm, tables, ms, idx, parallel=config.parallel)

            mu_new = sm @ Hm
            var_new = tables.hPSh[car, idx]  # (T, C) steady smoothed variances
            if itt > 0:
                maxdiff[itt] = torch.maximum((mu_new - mu).abs().max(),
                                             (var_new - var).abs().max())
            mu, var = mu_new, var_new

        if itt < config.ep_itts - 1:
            with span("nsgp.resite"):
                sites, lZ = _resite(mp, params, config, y, mask, mu, var, sites,
                                    config.damp(itt + 1), exclude_last=seq)
            if seq:
                lZ = torch.cat([lZ[:-1], lZ_last[None]])
            nlZ[itt + 1] = -torch.sum(lZ)
            lZ_final = lZ
            score = nlZ[itt + 1]
        elif config.keep_best:
            # score the final sweep's posterior the same way (sites discarded)
            with span("nsgp.resite"):
                _, lZ_eval = _resite(mp, params, config, y, mask, mu, var, sites, 0.0,
                                     exclude_last=seq)
            score = -torch.sum(lZ_eval)
        if config.keep_best:
            if itt == 0:
                best = (score, mu, var)
            else:
                better = score < best[0]
                best = (torch.where(better, score, best[0]), torch.where(better, mu, best[1]),
                        torch.where(better, var, best[2]))

    if config.keep_best:
        mu, var = best[1], best[2]
    if seq and config.ep_itts > 1:
        lZ_final = torch.cat([lZ_final[:-1], lZ_last[None]])
    return IHGPResult(Eft=mu, Varft=var, lZ=lZ_final, sites=sites, nlZ=nlZ, maxdiff=maxdiff)


@spanned("nsgp.ihgp_energy")
def ihgp_energy(
    model: GTNMFModel,
    params: GTNMFParams,
    y: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    config: IHGPConfig = IHGPConfig(),
    device=None,  # None = the card; "cpu" runs on the CPU
) -> torch.Tensor:
    """ADF single-sweep negative log marginal likelihood (ref
    ihgp_ep_modulator_nmf.m:533-624: energy mode is one ADF sweep).  A 0-d
    tensor differentiable by autograd with respect to every ``GTNMFParams``
    leaf, through the DARE doubling iterations.  The sweep is
    ``FusedIHGPADF``: on the card one launch of K5 forward and one of its
    adjoint K8 backward, whatever T."""
    full_fp32()
    with span("nsgp.assemble"):
        dev, params, y, mask = place_inputs(params, y, mask, device)
        T = y.shape[0]
        ssm = model.build_ssm(params)
        with span("nsgp.tables"):
            tables = build_tables(ssm, config, smoother=False)
    zeros = torch.zeros((T, ssm.num_channels), dtype=ssm.A.dtype, device=dev)
    with span("nsgp.sweep1"):
        _, _, lZ, _ = _steady_filter_seq(ssm, tables, y, mask, Sites(zeros, zeros),
                                         model.moment_params(), params.W, params.lik,
                                         config.damp(0),
                                         torch.ones((T,), dtype=torch.bool, device=dev),
                                         sweep=fih.fused_ihgp_adf_autograd)
        return -torch.sum(lZ)
