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
  and the all-T re-site.  On CUDA tensors every pass, and every re-site
  (K9), is one hand-written kernel launch; on CPU tensors the same passes run
  as their plain torch versions.

``ep_energy`` is the energy mode, whatever the backend: sweep 1 through
``fused_kalman.FusedADF`` (K3 forward, its adjoint K7 backward; their plain
twins on the CPU), later sweeps the sequential engine under autograd, whose
re-sites are ``fused_kalman.FusedResite`` on the card (K9 forward, its plain
twin's VJP backward); differentiable with respect to every ``GTNMFParams``
leaf.

Sharding over a mesh (``parallel.mesh``; the axis names resolve against the
ambient mesh of ``parallel.mesh.set_mesh``).  Every rank returns the same
result, in the unsharded layout (full T, full C):

- ``channel_axis``: each rank runs the fixed-site smoother and forward passes
  (K1/K2 on ``"fused"``) on its contiguous run of channels.  Sweep 1 (ADF),
  the sequential engine's forward passes (they re-match the last site, which
  couples the channels) and the re-site (its moments need every channel at a
  step) stay replicated; the (T, C) observable marginals are gathered before
  each re-site, the smoothed states once at return.
- ``time_axis`` (``parallel=True``, ``chunk > 0``): each rank owns a run of
  the blocked scan's chunks (``ops.bscan``); sweep 1 is replicated; the
  sites stay split over T between sweeps (the re-site is independent per
  step), ``nlZ`` and ``maxdiff`` are reduced over the axis and the result is
  gathered once, at return.

Placement follows ``utils.device``: ``ep_infer`` and ``ep_energy`` move their
inputs to the card unless the caller passes ``device="cpu"``; without a card
the default raises.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from nsgp_tpu_torch.models.gtnmf import GTNMFModel, GTNMFParams
from nsgp_tpu_torch.ops import bscan, fused_kalman, kalman, pscan
from nsgp_tpu_torch.ops.kalman import PackedTrajectory, Sites
from nsgp_tpu_torch.ops.ssm import BlockSSM
from nsgp_tpu_torch.parallel.collectives import all_reduce, gather, mesh_axis, scatter
from nsgp_tpu_torch.ops.moments import moments
from nsgp_tpu_torch.utils.device import place_inputs
from nsgp_tpu_torch.utils.precision import full_fp32
from nsgp_tpu_torch.utils.trace import span, spanned

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
    channel_axis: str = ""  # mesh axis to split the channels over (needs an
    # ambient mesh: parallel.mesh.set_mesh / shard_inference_over_channels)
    time_axis: str = ""  # mesh axis to split the blocked scan's chunks over
    # (parallel=True, chunk > 0 only; shard_inference_over_time)

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
        # time sharding splits the blocked scan's chunks: nothing else reads it
        "time_axis": bool(cfg.time_axis) and not (cfg.parallel and cfg.chunk),
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
    sequential backend sets it; the fused backend re-sites all T).  Through
    ``fused_kalman.fused_resite``: K9, one launch, on CUDA tensors (under
    autograd its backward recomputes the plain twin); the plain twin
    ``fused_resite_plain`` on CPU tensors (``moments_chunked`` in chunks of
    ``cfg.moment_chunk`` sites).
    """
    if exclude_last:  # made on the device: a host write would sync
        mask = torch.cat([mask[:-1], torch.zeros_like(mask[-1:])])
    ttau, tnu, lZ = fused_kalman.fused_resite(
        model.moment_params(), y, mask, mu, var, sites.ttau, sites.tnu, params.W, params.lik,
        frac=cfg.ep_fraction, damp=damp, chunk=cfg.moment_chunk)
    return Sites(ttau, tnu), lZ


def _forward_backward(ssm, sites: Sites, cfg: EPConfig, time=None, T=None):
    """Filter with fixed sites + RTS smooth.  Returns flattened smoothed
    trajectories (T, C*bs) / (T, C*bs*bs).  ``time``: the axis over which
    the blocked scan's chunks are split (``sites`` hold this rank's rows of a
    ``T``-step signal)."""
    if cfg.backend == "fused":
        return fused_kalman.filter_smoother_fused(ssm, sites)
    if cfg.parallel:
        if cfg.chunk:
            return bscan.blocked_filter_smoother(ssm, sites, cfg.chunk, axis=time, T=T)
        ms, Ps = pscan.filter_smoother_with_sites(ssm, sites, jitter=cfg.jitter)
        T = ms.shape[0]
        return ms.reshape(T, -1), Ps.reshape(T, -1)
    fr = kalman.filter_with_sites(ssm, sites, store=True, jitter=cfg.jitter)
    return kalman.rts_smoother(ssm, fr)


def _channel_slice(ssm: BlockSSM, lo: int, hi: int, axis) -> BlockSSM:
    """Channels [lo, hi) of ``ssm``, this rank's share under ``axis`` (the
    first ``ssm.D`` channels are subbands)."""
    n_sub = min(hi, ssm.D) - min(lo, ssm.D)
    return BlockSSM(*(scatter(x, axis, 0, lo, hi) for x in ssm[:7]), D=n_sub,
                    N=hi - lo - n_sub)


def _traj_channels(traj: PackedTrajectory, lo: int, hi: int, bs: int, axis) -> PackedTrajectory:
    """Channels [lo, hi) of a flattened (C-major) trajectory."""
    return PackedTrajectory(scatter(traj.ms, axis, 1, lo * bs, hi * bs),
                            scatter(traj.Ps, axis, 1, lo * bs * bs, hi * bs * bs))


@spanned("nsgp.ep_infer")
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
    interpolation like the reference's NaN handling.  Under
    ``config.channel_axis`` / ``time_axis`` the ranks of the ambient mesh
    share the call (module docstring) and each returns the whole result.
    """
    _check_config(config)
    chan, tax = mesh_axis(config.channel_axis), mesh_axis(config.time_axis)
    full_fp32()
    with span("nsgp.assemble"):
        dev, params, y, mask = place_inputs(params, y, mask, device)
        ssm = model.build_ssm(params)
        dtype = ssm.A.dtype
        T = y.shape[0]
        C, bs = ssm.num_channels, ssm.block_size
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

        # This rank's channels [c0, c1) and, from sweep 1's re-site on, its rows
        # (all of them unsharded).
        c0, c1 = chan.split(C) if chan else (0, C)
        ssm_c = _channel_slice(ssm, c0, c1, chan) if chan else ssm
        own_channels = lambda s: Sites(s.ttau[:, c0:c1], s.tnu[:, c0:c1]) if chan else s
        rows = slice(0, T)
        if tax:
            nc = -(-T // config.chunk)
            if nc < tax.size:
                raise ValueError(f"{nc} chunks of {config.chunk} steps cannot be split over "
                                 f"{tax.size} ranks of axis {tax.name!r}")
            k0, k1 = tax.split(nc)
            rows = slice(k0 * config.chunk, min(k1 * config.chunk, T))
        split_rows = tax is not None and config.ep_itts > 1
        y_r, mask_r = y[rows], mask[rows]

        def marginals(ms, Ps):
            mu, var = kalman.observable_marginals(ssm_c, ms, Ps)
            if chan:
                mu, var = gather(torch.stack([mu, var]), chan, 2, c0, C).unbind(0)
            return mu, var

        nlZ = torch.zeros((config.ep_itts,), dtype=dtype, device=dev)
        maxdiff = torch.full((config.ep_itts,), float("inf"), dtype=dtype, device=dev)
        lZ_final = torch.zeros((T,), dtype=dtype, device=dev)
        lZ_last = torch.zeros((), dtype=dtype, device=dev)

    mu = var = None
    for itt in range(config.ep_itts):
        damp = config.damp(itt)
        with span("nsgp.sweep1" if itt == 0 else "nsgp.pass"):
            if itt == 0:
                # Replicated: the moment match couples every channel at each step.
                if fused:
                    ms_f, Ps_f, lZ, sites = fused_kalman.adf_filter_fused(
                        model.moment_params(), ssm, params.W, params.lik, y, mask, damp
                    )
                    ms, Ps = fused_kalman.smoother_fused(ssm_c, ms_f[:, c0:c1], Ps_f[:, c0:c1])
                else:
                    fr, lZ, sites = kalman.adf_filter(ssm, y, mask, sites, mom_fn, damp,
                                                      match_mask=None)
                    ms, Ps = kalman.rts_smoother(ssm_c, _traj_channels(fr, c0, c1, bs, chan)
                                                 if chan else fr)
                nlZ[0] = -torch.sum(lZ)
                lZ_final = lZ
                lZ_last = lZ[-1]
            elif all_T:
                ms, Ps = _forward_backward(ssm_c, own_channels(sites), config, tax, T)
            else:
                # Reference quirk: later forward passes still re-match the site
                # at the very last step (itt == 1 || k == numel(yall) branch);
                # that couples the channels, so this pass is replicated.
                fr, lZ_fwd, sites = kalman.adf_filter(ssm, y, mask, sites, mom_fn, damp,
                                                      match_mask=last_only)
                lZ_last = lZ_fwd[-1]
                ms, Ps = kalman.rts_smoother(ssm_c, _traj_channels(fr, c0, c1, bs, chan)
                                             if chan else fr)

            mu_new, var_new = marginals(ms, Ps)
            if itt == 0 and split_rows:
                mu_new, var_new = mu_new[rows], var_new[rows]
                sites = Sites(sites.ttau[rows], sites.tnu[rows])
            if itt > 0:
                # Convergence monitor (ref gf_ep_modulator.m:279-289).
                md = torch.maximum((mu_new - mu).abs().max(), (var_new - var).abs().max())
                maxdiff[itt] = all_reduce(md, tax, "max") if tax else md
            mu, var = mu_new, var_new

        if itt < config.ep_itts - 1:
            with span("nsgp.resite"):
                sites, lZ = _ep_resite(model, params, config, y_r, mask_r, mu, var, sites,
                                       config.damp(itt + 1), exclude_last=seq)
                if seq:
                    lZ = lZ.clone()
                    lZ[-1] = lZ_last
                total = torch.sum(lZ)
                nlZ[itt + 1] = -(all_reduce(total, tax) if tax else total)
                lZ_final = lZ

    if seq and config.ep_itts > 1:
        # The final forward pass refreshed site T after the last re-site;
        # the reference's out.lZ carries that fresher value (:141, :313).
        lZ_final = lZ_final.clone()
        lZ_final[-1] = lZ_last
    if chan:
        ms = gather(ms, chan, 1, c0 * bs, C * bs)
        Ps = gather(Ps, chan, 1, c0 * bs * bs, C * bs * bs)
    if split_rows:
        mu, var, lZ_final, tt, tn, ms, Ps = (
            gather(x, tax, 0, rows.start, T)
            for x in (mu, var, lZ_final, sites.ttau, sites.tnu, ms, Ps))
        sites = Sites(tt, tn)

    return EPResult(Eft=mu, Varft=var, lZ=lZ_final, sites=sites, nlZ=nlZ,
                    ms=ms, Ps=Ps, maxdiff=maxdiff)


@spanned("nsgp.ep_energy")
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
    Sweep 1 is ``fused_kalman.FusedADF`` whatever ``config.backend`` says:
    K3 forward and its adjoint K7 backward on the card, their plain twins on
    the CPU.  Later sweeps are the sequential engine under autograd, with
    the reference's last-site bookkeeping: re-sites at ``config.damp(itt)``,
    the last step never re-sited backward, and later forward passes
    re-matching only the last site.  Under ``config.channel_axis`` sweep 1
    stays replicated, each rank smooths its channels and the marginals are
    gathered with their gradient (every rank returns the same energy; its
    backward pass exchanges too).
    """
    _check_config(config)
    chan = mesh_axis(config.channel_axis)
    full_fp32()
    with span("nsgp.assemble"):
        dev, params, y, mask = place_inputs(params, y, mask, device)
        ssm = model.build_ssm(params)
        T = y.shape[0]
        C, bs = ssm.num_channels, ssm.block_size
        mom_fn = _mom_point(model, params)
        c0, c1 = chan.split(C) if chan else (0, C)
        ssm_c = _channel_slice(ssm, c0, c1, chan) if chan else ssm

    # Sweep 1: ADF, K3 forward and K7 backward (their twins on the CPU);
    # this is the lZ if ep_itts == 1.
    with span("nsgp.sweep1"):
        ms1, Ps1, lZ, sites = fused_kalman.adf_filter_fused(model.moment_params(), ssm,
                                                            params.W, params.lik, y, mask,
                                                            config.damp(0))
    fr = PackedTrajectory(ms1.reshape(T, -1), Ps1.reshape(T, -1))
    lZ_last = lZ[-1]  # forward-pass lZ at the final step (ref :413)
    last_only = torch.arange(T, device=dev) == T - 1  # no host write, which would sync
    for itt in range(1, config.ep_itts):
        # the smoother closes the sweep before it, as in ep_infer
        with span("nsgp.sweep1" if itt == 1 else "nsgp.pass"):
            if chan:
                ms, Ps = kalman.rts_smoother(ssm_c, _traj_channels(fr, c0, c1, bs, chan))
                mu, var = kalman.observable_marginals(ssm_c, ms, Ps)
                mu, var = gather(torch.stack([mu, var]), chan, 2, c0, C).unbind(0)
            else:
                ms, Ps = kalman.rts_smoother(ssm, fr)
                mu, var = kalman.observable_marginals(ssm, ms, Ps)
        with span("nsgp.resite"):
            sites, lZ = _ep_resite(model, params, config, y, mask, mu, var, sites,
                                   config.damp(itt), exclude_last=True)
            lZ = torch.cat([lZ[:-1], lZ_last[None]])
        if itt < config.ep_itts - 1:
            with span("nsgp.pass"):
                fr, lZ_fwd, sites = kalman.adf_filter(ssm, y, mask, sites, mom_fn,
                                                      config.damp(itt), match_mask=last_only)
                lZ_last = lZ_fwd[-1]
    return -torch.sum(lZ)
