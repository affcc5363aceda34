"""Batched multi-signal Power-EP: BF files through the card at once.

Port of ``nsgp_tpu/inference/batched.py`` (EP part).  All files share
(D, N, kernels) and are padded to one T with mask=False padding; per-file
hyperparameters differ freely (stacked ``GTNMFParams``, leading (BF,) axis).

- ``backend="fused"`` (JAX ``"pallas"``): sweep 1 is the batched ADF kernel
  (one CTA a file) then the smoother kernel; sweeps >= 2 re-site every file
  at its smoothed cavity (all T, ``exclude_last=False``), then run the filter
  and smoother kernels over all BF*(D+N) channels in one launch each.  The
  sweep loop runs on the host and carries per-file ``nlZ`` / ``maxdiff`` of
  shape (BF, ep_itts).
- ``backend="seq"`` (the JAX ``vmap`` branch): the single-file ``ep_infer``
  looped over the files.

``ihgp_infer_batch`` runs the single-file IHGP engine over the files, each
with its own DARE bank, and stacks the results on a leading file axis (the
JAX package vmaps the same function).

``giekf_infer_batch`` runs the GIEKF engine over the files as one loop over
T: (BF, m) means and (BF, m, m) covariances, batched dense algebra in every
step, each file's update kept or dropped by ``torch.where`` on its own mask
(JAX's ``vmap`` of the single-file scan does the same), and the pass gate
per file.

On the card a file is a thread block, so the layout is simply (file,
channel): the JAX package's ``flatten_ssm_zmajor``, ``_to_per_file``,
``_to_flat`` and ``_block_diag_WT`` only arrange files on TPU lanes and have
no counterpart here.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from nsgp_tpu_torch.inference import ep as ep_mod
from nsgp_tpu_torch.inference import giekf as giekf_mod
from nsgp_tpu_torch.inference.ep import EPConfig
from nsgp_tpu_torch.models.gtnmf import GTNMFModel, GTNMFParams
from nsgp_tpu_torch.ops import fused_kalman
from nsgp_tpu_torch.ops.kalman import Sites
from nsgp_tpu_torch.ops.moments import LINKS
from nsgp_tpu_torch.ops.ssm import flatten_files
from nsgp_tpu_torch.utils.device import resolve_device
from nsgp_tpu_torch.utils.precision import full_fp32
from nsgp_tpu_torch.utils.trace import span, spanned


class BatchEPResult(NamedTuple):
    Eft: torch.Tensor  # (BF, T, C)
    Varft: torch.Tensor  # (BF, T, C)
    nlZ: torch.Tensor  # (BF, ep_itts)
    maxdiff: torch.Tensor  # (BF, ep_itts)
    sites: Sites  # (BF, T, C)


def _per_file(x, BF: int):
    """(T, BF*C) or (T, BF, C) -> (BF, T, C)."""
    return x.reshape(x.shape[0], BF, -1).permute(1, 0, 2)


def _marginals(H, ms, Ps, BF: int):
    """Observable mean and variance per channel, as (BF, T, C).  H (BF*C, bs);
    ms (T, BF*C, bs), Ps (T, BF*C, bs, bs).  Channel by channel, so one file's
    values never enter another's sums."""
    mu = (ms * H).sum(-1)
    HH = H[:, :, None] * H[:, None, :]
    var = (Ps * HH).sum((-1, -2))
    return _per_file(mu, BF), _per_file(var, BF)


@spanned("nsgp.ep_infer_batch")
def ep_infer_batch(
    model: GTNMFModel,
    paramsB: GTNMFParams,  # buffers with a leading (BF,) file axis
    yB: torch.Tensor,  # (BF, T); NaNs allowed (-> missing)
    maskB: Optional[torch.Tensor] = None,  # (BF, T) bool; default = ~isnan(yB)
    config: EPConfig = EPConfig(),
    device=None,  # None = the card; "cpu" runs the plain versions
) -> BatchEPResult:
    """Power-EP inference over BF files at once.  Per file the result equals
    ``ep_infer`` with the same backend."""
    ep_mod._check_config(config)
    full_fp32()
    fused = config.backend == "fused"
    with span("nsgp.assemble"):
        dev = resolve_device(device)
        paramsB = paramsB.on(dev)
        yB = yB.to(dev)
        maskB = ~torch.isnan(yB) if maskB is None else maskB.to(dev, torch.bool)
        BF, T = yB.shape
        if fused:
            ssmB = model.build_ssm_batch(paramsB)
            flat = flatten_files(ssmB)
            pad = torch.diagonal(flat.pad_eye, dim1=-2, dim2=-1)
            dtype = ssmB.A.dtype
            yB = torch.nan_to_num(yB).to(dtype)
            bs = ssmB.block_size

    if not fused:
        rs = [ep_mod.ep_infer(model, paramsB.select(b), yB[b], maskB[b], config, device=dev)
              for b in range(BF)]
        stack = lambda xs: torch.stack(list(xs))
        return BatchEPResult(
            Eft=stack(r.Eft for r in rs), Varft=stack(r.Varft for r in rs),
            nlZ=stack(r.nlZ for r in rs), maxdiff=stack(r.maxdiff for r in rs),
            sites=Sites(stack(r.sites.ttau for r in rs), stack(r.sites.tnu for r in rs)))

    def smooth(ms_f, Ps_f):
        """Smoother kernel over all files' channels -> per-file marginals."""
        ms, Ps = fused_kalman.fused_bwd(ms_f.reshape(T, -1, bs), Ps_f.reshape(T, -1, bs, bs),
                                        flat.A, flat.Q, pad)
        return _marginals(flat.H, ms, Ps, BF)

    # ---- sweep 1: batched ADF + smoother -------------------------------------
    with span("nsgp.sweep1"):
        ms_f, Ps_f, lZ, sites = fused_kalman.adf_filter_fused_mb(
            model.moment_params(), ssmB, paramsB.W, paramsB.lik, yB.T, maskB.T,
            config.damp(0), config.s_chunk)
        mu, var = smooth(ms_f, Ps_f)
        tt, tn = _per_file(sites.ttau, BF), _per_file(sites.tnu, BF)
        nlZ = [-lZ.sum(0)]
        maxdiff = [torch.full((BF,), float("inf"), dtype=dtype, device=dev)]

    # ---- sweeps >= 2: re-site per file, then filter + smoother ---------------
    files = [paramsB.select(b) for b in range(BF)]
    for itt in range(1, config.ep_itts):
        resited = []
        for b in range(BF):
            with span("nsgp.resite"):
                resited.append(ep_mod._ep_resite(model, files[b], config, yB[b], maskB[b], mu[b],
                                                 var[b], Sites(tt[b], tn[b]), config.damp(itt)))
        with span("nsgp.pass"):
            tt = torch.stack([s.ttau for s, _ in resited])
            tn = torch.stack([s.tnu for s, _ in resited])
            nlZ.append(-torch.stack([lZ_b.sum() for _, lZ_b in resited]))
            ms_f, Ps_f = fused_kalman.fused_fwd(
                tt.permute(1, 0, 2).reshape(T, -1), tn.permute(1, 0, 2).reshape(T, -1),
                flat.A, flat.Q, flat.Pinf, flat.H)
            mu_new, var_new = smooth(ms_f, Ps_f)
            maxdiff.append(torch.maximum((mu_new - mu).abs().amax(dim=(1, 2)),
                                         (var_new - var).abs().amax(dim=(1, 2))))
            mu, var = mu_new, var_new

    return BatchEPResult(Eft=mu, Varft=var, nlZ=torch.stack(nlZ, dim=1),
                         maxdiff=torch.stack(maxdiff, dim=1), sites=Sites(tt, tn))


def ihgp_infer_batch(
    model: GTNMFModel,
    paramsB: GTNMFParams,  # buffers with a leading (BF,) file axis
    yB: torch.Tensor,  # (BF, T); NaNs allowed (-> missing)
    maskB: Optional[torch.Tensor] = None,  # (BF, T) bool; default = ~isnan(yB)
    config=None,  # IHGPConfig; None = its defaults
    device=None,  # None = the card; "cpu" runs on the CPU
):
    """IHGP inference over BF files: ``ihgp_infer`` per file (each its own
    DARE bank), every ``IHGPResult`` field stacked on a leading (BF,) axis."""
    from nsgp_tpu_torch.inference import ihgp as ihgp_mod

    config = ihgp_mod.IHGPConfig() if config is None else config
    dev = resolve_device(device)
    paramsB = paramsB.on(dev)
    yB = yB.to(dev)
    maskB = ~torch.isnan(yB) if maskB is None else maskB.to(dev, torch.bool)
    rs = [ihgp_mod.ihgp_infer(model, paramsB.select(b), yB[b], maskB[b], config, device=dev)
          for b in range(yB.shape[0])]
    stack = lambda f: torch.stack([getattr(r, f) for r in rs])
    return ihgp_mod.IHGPResult(
        Eft=stack("Eft"), Varft=stack("Varft"), lZ=stack("lZ"), nlZ=stack("nlZ"),
        maxdiff=stack("maxdiff"),
        sites=Sites(torch.stack([r.sites.ttau for r in rs]),
                    torch.stack([r.sites.tnu for r in rs])))


def _measurement_batch(model: GTNMFModel, W, f):
    """``giekf._measurement`` over files: W (BF, D, N), f (BF, C) ->
    (yhat (BF,), dh (BF, C))."""
    D = model.D
    z, g = f[:, :D], f[:, D:]
    Wl = (W @ LINKS[model.link](g)[:, :, None])[..., 0]  # (BF, D)
    da_dg = W * giekf_mod._LINK_DERIVATIVES[model.link](g)[:, None, :]  # (BF, D, N)
    if model.variant == "sq":
        a = torch.sqrt(torch.clamp_min(Wl, 1e-12))
        da_dg = da_dg / (2.0 * a[:, :, None])
    else:
        a = Wl
    return (z * a).sum(-1), torch.cat([a, (z[:, None, :] @ da_dg)[:, 0]], dim=-1)


def _mv(M, v):
    """Batched matrix-vector product: (..., m, n) @ (..., n) -> (..., m)."""
    return (M @ v[..., None])[..., 0]


def _giekf_filter_batch(model, W, sn2, A, Q, Hd, yB, maskB, m0, P0, l_iter: int):
    """``giekf._filter`` over BF files in one loop over T.  Every step
    computes the update for all files; a file whose step is unobserved, or
    whose update the divergence guard rejects, keeps the pure prediction and
    adds nothing to its NLL (JAX's ``vmap`` of the single-file scan does the
    same).  A step no file observes is a pure prediction for all; the masks
    reach the host once.  Returns (ms (BF, T, m), Ps (BF, T, m, m),
    nll (BF,))."""
    BF, m_dim = m0.shape
    eye = torch.eye(m_dim, dtype=A.dtype, device=A.device)
    AT, HdT = A.transpose(-1, -2), Hd.transpose(-1, -2)
    mx, P = m0, P0
    ms, Ps, nlls = [], [], []
    for k, any_obs in enumerate(maskB.any(0).tolist()):
        if k > 0:
            mx, P = _mv(A, mx), A @ P @ AT + Q
        P = 0.5 * (P + P.transpose(-1, -2))
        if any_obs:
            obs, y_k = maskB[:, k], yB[:, k]
            yhat, dh = _measurement_batch(model, W, _mv(Hd, mx))
            J = _mv(HdT, dh)  # dh @ Hd
            PJ = _mv(P, J)
            S0 = S = (J * PJ).sum(-1) + sn2
            nll_k = 0.5 * (torch.log(2.0 * math.pi * S0) + (y_k - yhat) ** 2 / S0)
            M, K = mx, PJ / S[:, None]
            for i in range(l_iter):
                if i > 0:
                    yhat, dh = _measurement_batch(model, W, _mv(Hd, M))
                    J = _mv(HdT, dh)
                    PJ = _mv(P, J)
                    S = (J * PJ).sum(-1) + sn2
                    K = PJ / S[:, None]
                M = M + K * (y_k - yhat)[:, None]
            ImKJ = eye - K[:, :, None] * J[:, None, :]
            P_upd = ImKJ @ P @ ImKJ.transpose(-1, -2) + sn2[:, None, None] * (
                K[:, :, None] * K[:, None, :])
            P_upd = 0.5 * (P_upd + P_upd.transpose(-1, -2))
            ok = (obs & (S0 > 0.0) & (S > 0.0) & torch.isfinite(M).all(-1)
                  & torch.isfinite(P_upd).all(-1).all(-1))
            mx = torch.where(ok[:, None], M, mx)
            P = torch.where(ok[:, None, None], P_upd, P)
            nlls.append(torch.where(ok, nll_k, torch.zeros_like(nll_k)))
        ms.append(mx)
        Ps.append(P)
    nll = torch.stack(nlls).sum(0) if nlls else torch.zeros((BF,), dtype=A.dtype,
                                                            device=A.device)
    return torch.stack(ms, 1), torch.stack(Ps, 1), nll


def _rts_dense_batch(A, Q, ms, Ps, jitter: float):
    """``giekf._rts_dense`` over files: all gains from one batched solve,
    then one backward loop for every file."""
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    A4, AT4 = A[:, None], A.transpose(-1, -2)[:, None]
    Pp = A4 @ Ps[:, :-1] @ AT4 + Q[:, None] + jitter * eye  # (BF, T-1, m, m)
    G = torch.linalg.solve(Pp.transpose(-1, -2), (Ps[:, :-1] @ AT4).transpose(-1, -2))
    G = G.transpose(-1, -2)
    m, P = ms[:, -1], Ps[:, -1]
    out_m, out_P = [m], [P]
    for k in range(ms.shape[1] - 2, -1, -1):
        Gk = G[:, k]
        m = ms[:, k] + _mv(Gk, m - _mv(A, ms[:, k]))
        P = Ps[:, k] + Gk @ (P - Pp[:, k]) @ Gk.transpose(-1, -2)
        P = 0.5 * (P + P.transpose(-1, -2))
        out_m.append(m)
        out_P.append(P)
    return torch.stack(out_m[::-1], 1), torch.stack(out_P[::-1], 1)


def giekf_infer_batch(
    model: GTNMFModel,
    paramsB: GTNMFParams,  # buffers with a leading (BF,) file axis
    yB: torch.Tensor,  # (BF, T); NaNs allowed (-> missing)
    maskB: Optional[torch.Tensor] = None,  # (BF, T) bool; default = ~isnan(yB)
    config=None,  # GIEKFConfig; None = its defaults
    device=None,  # None = the card; "cpu" runs on the CPU
):
    """GIEKF inference over BF files: per file the result of ``giekf_infer``,
    every ``GIEKFResult`` field with a leading (BF,) axis.

    One loop over T serves all files (``_giekf_filter_batch``).  Pass gates
    per file, as JAX's: a pass that is not finite for a file, or whose NLL
    regressed past ``accept_tol`` there, leaves that file's kept posterior
    as it was; every file's next pass warm-starts from its own kept smoothed
    (m, P) at k = 0.  The single-file engine keeps its own 2-D loop: at one
    file it is 10-25% faster a step on the card than this one (PERF.md)."""
    config = giekf_mod.GIEKFConfig() if config is None else config
    full_fp32()
    dev = resolve_device(device)
    paramsB = paramsB.on(dev)
    yB = yB.to(dev)
    maskB = ~torch.isnan(yB) if maskB is None else maskB.to(dev, torch.bool)
    yB = torch.nan_to_num(yB).to(paramsB.sub_var.dtype)
    dense = [giekf_mod.dense_model(model.build_ssm(paramsB.select(b)))
             for b in range(yB.shape[0])]
    A, Q, Pinf, Hd = (torch.stack(x) for x in zip(*dense))
    m0, P0 = torch.zeros(A.shape[:2], dtype=A.dtype, device=dev), Pinf

    ms = Ps = nll = None
    for g in range(config.g_iter):
        msf, Psf, nll_g = _giekf_filter_batch(model, paramsB.W, paramsB.lik, A, Q, Hd, yB, maskB,
                                              m0, P0, config.l_iter)
        ms_g, Ps_g = _rts_dense_batch(A, Q, msf, Psf, config.jitter)
        del msf, Psf
        good = (torch.isfinite(ms_g).flatten(1).all(1) & torch.isfinite(Ps_g).flatten(1).all(1)
                & torch.isfinite(nll_g))
        if ms is None:
            ms, Ps, nll = ms_g, Ps_g, nll_g
        else:
            if config.accept_tol >= 0.0:
                good = good & (nll_g <= nll + config.accept_tol * torch.abs(nll))
            ms = torch.where(good[:, None, None], ms_g, ms)
            Ps = torch.where(good[:, None, None, None], Ps_g, Ps)
            nll = torch.where(good, nll_g, nll)
        del ms_g, Ps_g
        m0, P0 = ms[:, 0], Ps[:, 0]

    Eft = ms @ Hd.transpose(-1, -2)  # (BF, T, C)
    Varft = torch.einsum("bci,btij,bcj->btc", Hd, Ps, Hd)
    return giekf_mod.GIEKFResult(Eft=Eft, Varft=Varft, ms=ms, Ps=Ps, nll=nll)


def infer_batch(engine: str, model, paramsB, yB, maskB=None, config=None, device=None,
                **cfg_kwargs):
    """Batched analogue of ``registry.infer`` over the leading file axis of
    (paramsB, yB, maskB).  Every ``"ihgp*"`` name (``"ihgp_ref"``,
    ``"ihgp_tuned"``, ...) is the IHGP engine, as in the JAX package."""
    from nsgp_tpu_torch.inference import registry

    ihgp = engine.startswith("ihgp")
    _, _, config_cls = registry.get_engine("ihgp" if ihgp else engine)
    cfg = config if config is not None else config_cls(**cfg_kwargs)
    if ihgp:
        return ihgp_infer_batch(model, paramsB, yB, maskB, cfg, device=device)
    if engine == "giekf":
        return giekf_infer_batch(model, paramsB, yB, maskB, cfg, device=device)
    return ep_infer_batch(model, paramsB, yB, maskB, cfg, device=device)
