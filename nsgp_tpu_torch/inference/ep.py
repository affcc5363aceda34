"""Power EP inference for the GT-NMF model family.

Port of ``nsgp_tpu/inference/ep.py`` (ref gf_ep_modulator_nmf.m):

- sweep 1 = ADF: sites matched at the forward-filter marginal (the site at
  step k feeds the filter at steps > k),
- sweeps >= 2: forward filter with *fixed* sites, RTS smoothing, then EP
  site re-matching at the smoothed cavity for all T at once.

    site:    ttau <- (1-d*frac)*ttau + d*(-d2lZ/(1+d2lZ*v))
             tnu  <- (1-d*frac)*tnu  + d*((dlZ-mu*d2lZ)/(1+d2lZ*v))
    cavity:  v_cav = 1/(1/v_marg - frac*ttau),
             m_cav = v_cav*(m_marg/v_marg - frac*tnu)
    clamp ttau >= 0; update only sites with v_cav > 0; nlml = -sum_k lZ_k.

Two backends:

- ``"seq"`` (JAX ``"xla"``): the sequential engine of ``ops.kalman`` with
  the reference's last-site bookkeeping.  Python loops over T — small T.
  With ``parallel=True`` the fixed-site sweeps (>= 2) run the blocked
  two-level scans of ``ops.bscan`` (``chunk > 0``) or the one-level
  log-depth scans of ``ops.pscan`` (``chunk = 0``) and re-site all T, as the
  JAX package's parallel path does.  ``jitter`` (the smoother's
  pseudo-prediction ridge) acts where JAX's does, on the one-level path; the
  blocked and fused passes ignore it, as JAX's blocked and Pallas passes do.
- ``"fused"`` (JAX ``"pallas"``): the fused passes of ``ops.fused_kalman``
  and the all-T re-site.  On CUDA tensors every pass is one hand-written
  kernel launch; on CPU tensors the same passes run as their plain torch
  versions.

``ep_energy`` is the energy mode: the sequential engine whatever the backend,
differentiable by autograd with respect to every ``GTNMFParams`` leaf.

Placement follows ``utils.device``: ``ep_infer`` and ``ep_energy`` move their
inputs to the card unless the caller passes ``device="cpu"``; without a card
the default raises.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from nsgp_tpu_torch.models.gtnmf import GTNMFModel, GTNMFParams
from nsgp_tpu_torch.ops import bscan, fused_kalman, kalman, pscan
from nsgp_tpu_torch.ops.kalman import Sites
from nsgp_tpu_torch.ops.moments import moments, moments_chunked
from nsgp_tpu_torch.utils.device import place_inputs
from nsgp_tpu_torch.utils.precision import full_fp32

BACKENDS = ("seq", "fused")


class EPConfig(NamedTuple):
    """EP solver knobs."""

    ep_fraction: float = 0.5
    ep_itts: int = 3
    damping: tuple = ()  # per-iteration damping; empty = 0.5 everywhere
    moment_chunk: int = 4096  # sites per batched re-site call
    backend: str = "seq"  # 'seq' | 'fused'
    s_chunk: int = 0  # sigma points per rescale chunk of the batched ADF
    # kernel (0 = all in one chunk); the single-signal kernel ignores it
    parallel: bool = False  # backend 'seq': parallel-in-time passes
    chunk: int = 512  # blocked-scan chunk of the parallel path (0 = the
    # one-level log-depth scan)
    jitter: float = 0.0  # smoother pseudo-prediction ridge (one-level path)
    # Not ported yet (they raise NotImplementedError when set):
    channel_axis: str = ""  # channel sharding
    time_axis: str = ""  # time sharding

    def damp(self, itt: int) -> float:
        if len(self.damping) == 0:
            return 0.5
        return self.damping[min(itt, len(self.damping) - 1)]


class EPResult(NamedTuple):
    Eft: torch.Tensor  # (T, C) posterior mean of H x (subbands then modulators)
    Varft: torch.Tensor  # (T, C) posterior marginal variance
    lZ: torch.Tensor  # (T,) site log-normalizers from the last EP pass
    sites: Sites
    nlZ: torch.Tensor  # (ep_itts,) per-sweep negative log marginal likelihood
    ms: torch.Tensor  # (T, C*bs) smoothed state means, trailing axis flattened
    Ps: torch.Tensor  # (T, C*bs*bs) smoothed state covariances, flattened
    maxdiff: torch.Tensor  # (ep_itts,) max |change| in posterior mean/variance
    # vs the previous sweep (gf_ep_modulator.m:279-289); entry 0 is inf


def _check_config(cfg: EPConfig) -> None:
    if cfg.backend not in BACKENDS:
        raise ValueError(f"unknown backend {cfg.backend!r}; available: {BACKENDS}")
    unported = {
        # the fused backend has its own blocked passes inside the kernels and
        # no parallel switch
        "parallel": cfg.parallel and cfg.backend != "seq",
        # a chunk set without the path that reads it
        "chunk": not cfg.parallel and cfg.chunk != EPConfig._field_defaults["chunk"],
        "channel_axis": bool(cfg.channel_axis),
        "time_axis": bool(cfg.time_axis),
    }
    bad = [k for k, v in unported.items() if v]
    if bad:
        raise NotImplementedError(f"EPConfig fields not ported yet, or set without the option "
                                  f"that reads them: {bad}")


def _mom_point(model: GTNMFModel, params: GTNMFParams):
    """Per-step moment closure for the sequential ADF pass."""
    mp = model.moment_params()

    def mom_fn(y_k, fmu, fs2, frac):
        return moments(mp, params.lik, y_k, fmu, fs2, params.W, frac)

    return mom_fn


def _ep_resite(
    model: GTNMFModel,
    params: GTNMFParams,
    cfg: EPConfig,
    y: torch.Tensor,
    mask: torch.Tensor,
    mu: torch.Tensor,  # (T, C) smoothed observable means
    var: torch.Tensor,  # (T, C) smoothed observable variances
    sites: Sites,
    damp: float,
    exclude_last: bool = False,
):
    """Vectorized EP site re-matching at the smoothed cavity (all T at once).

    Ref gf_ep_modulator_nmf.m:240-267.  ``exclude_last`` reproduces the
    reference's backward loop, which never re-sites the last step (the
    sequential backend sets it; the fused backend re-sites all T).
    """
    if exclude_last:
        mask = mask.clone()
        mask[-1] = False
    frac = cfg.ep_fraction
    mp = model.moment_params()
    v_cav_raw = 1.0 / (1.0 / var - frac * sites.ttau)
    ok = (v_cav_raw > 0.0) & mask[:, None]
    v_cav = torch.where(ok, v_cav_raw, torch.ones_like(v_cav_raw))
    m_cav = torch.where(ok, v_cav_raw * (mu / var - frac * sites.tnu),
                        torch.zeros_like(v_cav_raw))

    lZ, dlZ, d2lZ = moments_chunked(
        mp, params.lik, y, m_cav, v_cav, params.W, frac, chunk=cfg.moment_chunk
    )
    lZ = torch.where(mask, lZ, torch.zeros_like(lZ))

    denom = 1.0 + d2lZ * v_cav
    ttau_prop = (1.0 - damp * frac) * sites.ttau + damp * (-d2lZ / denom)
    tnu_prop = (1.0 - damp * frac) * sites.tnu + damp * ((dlZ - m_cav * d2lZ) / denom)
    ttau = torch.where(ok, ttau_prop, sites.ttau)
    tnu = torch.where(ok, tnu_prop, sites.tnu)
    return Sites(torch.clamp_min(ttau, 0.0), tnu), lZ


def _forward_backward(ssm, sites: Sites, cfg: EPConfig):
    """Filter with fixed sites + RTS smooth.  Returns flattened smoothed
    trajectories (T, C*bs) / (T, C*bs*bs)."""
    if cfg.backend == "fused":
        return fused_kalman.filter_smoother_fused(ssm, sites)
    if cfg.parallel:
        if cfg.chunk:
            return bscan.blocked_filter_smoother(ssm, sites, cfg.chunk)
        ms, Ps = pscan.filter_smoother_with_sites(ssm, sites, jitter=cfg.jitter)
        T = ms.shape[0]
        return ms.reshape(T, -1), Ps.reshape(T, -1)
    fr = kalman.filter_with_sites(ssm, sites, store=True, jitter=cfg.jitter)
    return kalman.rts_smoother(ssm, fr)


def ep_infer(
    model: GTNMFModel,
    params: GTNMFParams,
    y: torch.Tensor,  # (T,) observations; NaNs allowed (-> missing)
    mask: Optional[torch.Tensor] = None,  # (T,) bool; default = ~isnan(y)
    config: EPConfig = EPConfig(),
    device=None,  # None = the card; "cpu" runs the plain versions
) -> EPResult:
    """Full Power-EP posterior inference (prediction mode of the reference).

    ``params``, ``y`` and ``mask`` are moved to ``device`` (the card by
    default; without one that raises) and the computation runs there in the
    parameters' dtype.  Missing steps (mask False / NaN y) get pure GP
    interpolation like the reference's NaN handling.
    """
    _check_config(config)
    full_fp32()
    dev, params, y, mask = place_inputs(params, y, mask, device)
    ssm = model.build_ssm(params)
    dtype = ssm.A.dtype
    T = y.shape[0]
    C = ssm.num_channels
    sites = kalman.init_sites(T, C, dtype, dev)
    mom_fn = _mom_point(model, params)
    fused = config.backend == "fused"
    # The sequential backend follows the reference's exact last-site
    # bookkeeping (forward re-match at k=T, backward re-site over k<T, nlZ
    # mixing the forward lZ(T) with the backward lZ(1..T-1) —
    # gf_ep_modulator_nmf.m:141, :207, :277).  Fused and parallel keep the
    # all-T re-site.
    all_T = fused or config.parallel
    seq = not all_T
    last_only = torch.zeros((T,), dtype=torch.bool, device=dev)
    last_only[-1] = True

    nlZ = torch.zeros((config.ep_itts,), dtype=dtype, device=dev)
    maxdiff = torch.full((config.ep_itts,), float("inf"), dtype=dtype, device=dev)
    lZ_final = torch.zeros((T,), dtype=dtype, device=dev)
    lZ_last = torch.zeros((), dtype=dtype, device=dev)

    mu = var = None
    for itt in range(config.ep_itts):
        damp = config.damp(itt)
        if itt == 0:
            if fused:
                ms_f, Ps_f, lZ, sites = fused_kalman.adf_filter_fused(
                    model.moment_params(), ssm, params.W, params.lik, y, mask, damp
                )
                ms, Ps = fused_kalman.smoother_fused(ssm, ms_f, Ps_f)
            else:
                fr, lZ, sites = kalman.adf_filter(ssm, y, mask, sites, mom_fn, damp,
                                                  match_mask=None, store=True)
                ms, Ps = kalman.rts_smoother(ssm, fr)
            nlZ[0] = -torch.sum(lZ)
            lZ_final = lZ
            lZ_last = lZ[-1]
        elif all_T:
            ms, Ps = _forward_backward(ssm, sites, config)
        else:
            # Reference quirk: later forward passes still re-match the site
            # at the very last step (itt == 1 || k == numel(yall) branch).
            fr, lZ_fwd, sites = kalman.adf_filter(ssm, y, mask, sites, mom_fn, damp,
                                                  match_mask=last_only, store=True)
            lZ_last = lZ_fwd[-1]
            ms, Ps = kalman.rts_smoother(ssm, fr)

        mu_new, var_new = kalman.observable_marginals(ssm, ms, Ps)
        if itt > 0:
            # Convergence monitor (ref gf_ep_modulator.m:279-289).
            maxdiff[itt] = torch.maximum((mu_new - mu).abs().max(),
                                         (var_new - var).abs().max())
        mu, var = mu_new, var_new

        if itt < config.ep_itts - 1:
            sites, lZ = _ep_resite(model, params, config, y, mask, mu, var, sites,
                                   config.damp(itt + 1), exclude_last=seq)
            if seq:
                lZ = lZ.clone()
                lZ[-1] = lZ_last
            nlZ[itt + 1] = -torch.sum(lZ)
            lZ_final = lZ

    if seq and config.ep_itts > 1:
        # The final forward pass refreshed site T after the last re-site;
        # the reference's out.lZ carries that fresher value (:141, :313).
        lZ_final = lZ_final.clone()
        lZ_final[-1] = lZ_last

    return EPResult(Eft=mu, Varft=var, lZ=lZ_final, sites=sites, nlZ=nlZ,
                    ms=ms, Ps=Ps, maxdiff=maxdiff)


def ep_energy(
    model: GTNMFModel,
    params: GTNMFParams,
    y: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    config: EPConfig = EPConfig(),
    device=None,  # None = the card; "cpu" runs the plain versions
) -> torch.Tensor:
    """Negative log marginal likelihood (energy mode, xt=[] in the ref).

    nlml = -sum_k lZ_k from the final EP moment evaluation
    (gf_ep_modulator_nmf.m:355-533).  A 0-d tensor whose graph reaches every
    leaf of ``params``: differentiable by autograd, which the reference lacks
    (it returns zero gradients and relies on fminunc finite differences).
    Always the sequential engine, whatever ``config.backend`` says, with the
    reference's last-site bookkeeping: re-sites at ``config.damp(itt)``, the
    last step never re-sited backward, and later forward passes re-matching
    only the last site.
    """
    _check_config(config)
    full_fp32()
    dev, params, y, mask = place_inputs(params, y, mask, device)
    ssm = model.build_ssm(params)
    dtype = ssm.A.dtype
    T = y.shape[0]
    sites = kalman.init_sites(T, ssm.num_channels, dtype, dev)
    mom_fn = _mom_point(model, params)

    # Sweep 1: ADF; this is the lZ if ep_itts == 1.
    fr, lZ, sites = kalman.adf_filter(ssm, y, mask, sites, mom_fn, config.damp(0),
                                      match_mask=None, store=config.ep_itts > 1)
    lZ_last = lZ[-1]  # forward-pass lZ at the final step (ref :413)
    last_only = torch.zeros((T,), dtype=torch.bool, device=dev)
    last_only[-1] = True
    for itt in range(1, config.ep_itts):
        ms, Ps = kalman.rts_smoother(ssm, fr)
        mu, var = kalman.observable_marginals(ssm, ms, Ps)
        sites, lZ = _ep_resite(model, params, config, y, mask, mu, var, sites,
                               config.damp(itt), exclude_last=True)
        lZ = torch.cat([lZ[:-1], lZ_last[None]])
        if itt < config.ep_itts - 1:
            fr, lZ_fwd, sites = kalman.adf_filter(ssm, y, mask, sites, mom_fn, config.damp(itt),
                                                  match_mask=last_only, store=True)
            lZ_last = lZ_fwd[-1]
    return -torch.sum(lZ)
