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

On the card a file is a thread block, so the layout is simply (file,
channel): the JAX package's ``flatten_ssm_zmajor``, ``_to_per_file``,
``_to_flat`` and ``_block_diag_WT`` only arrange files on TPU lanes and have
no counterpart here.  The batched GIEKF engine is not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from nsgp_tpu_torch.inference import ep as ep_mod
from nsgp_tpu_torch.inference.ep import EPConfig
from nsgp_tpu_torch.models.gtnmf import GTNMFModel, GTNMFParams
from nsgp_tpu_torch.ops import fused_kalman
from nsgp_tpu_torch.ops.kalman import Sites
from nsgp_tpu_torch.ops.ssm import flatten_files
from nsgp_tpu_torch.utils.device import resolve_device
from nsgp_tpu_torch.utils.precision import full_fp32


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
    dev = resolve_device(device)
    paramsB = paramsB.on(dev)
    yB = yB.to(dev)
    maskB = ~torch.isnan(yB) if maskB is None else maskB.to(dev, torch.bool)
    BF, T = yB.shape

    if config.backend != "fused":
        rs = [ep_mod.ep_infer(model, paramsB.select(b), yB[b], maskB[b], config, device=dev)
              for b in range(BF)]
        stack = lambda xs: torch.stack(list(xs))
        return BatchEPResult(
            Eft=stack(r.Eft for r in rs), Varft=stack(r.Varft for r in rs),
            nlZ=stack(r.nlZ for r in rs), maxdiff=stack(r.maxdiff for r in rs),
            sites=Sites(stack(r.sites.ttau for r in rs), stack(r.sites.tnu for r in rs)))

    ssmB = model.build_ssm_batch(paramsB)
    flat = flatten_files(ssmB)
    pad = torch.diagonal(flat.pad_eye, dim1=-2, dim2=-1)
    dtype = ssmB.A.dtype
    yB = torch.nan_to_num(yB).to(dtype)
    bs = ssmB.block_size

    def smooth(ms_f, Ps_f):
        """Smoother kernel over all files' channels -> per-file marginals."""
        ms, Ps = fused_kalman.fused_bwd(ms_f.reshape(T, -1, bs), Ps_f.reshape(T, -1, bs, bs),
                                        flat.A, flat.Q, pad)
        return _marginals(flat.H, ms, Ps, BF)

    # ---- sweep 1: batched ADF + smoother -------------------------------------
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
        resited = [ep_mod._ep_resite(model, files[b], config, yB[b], maskB[b], mu[b], var[b],
                                     Sites(tt[b], tn[b]), config.damp(itt))
                   for b in range(BF)]
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


def infer_batch(engine: str, model, paramsB, yB, maskB=None, config=None, device=None,
                **cfg_kwargs):
    """Batched analogue of ``registry.infer`` over the leading file axis of
    (paramsB, yB, maskB).  Every ``"ihgp*"`` name (``"ihgp_ref"``,
    ``"ihgp_tuned"``, ...) is the IHGP engine, as in the JAX package."""
    from nsgp_tpu_torch.inference import registry

    ihgp = engine.startswith("ihgp")
    _, _, config_cls = registry.get_engine("ihgp" if ihgp else engine)
    if engine == "giekf":
        raise NotImplementedError("batched GIEKF is not ported yet: ROADMAP Queue 1 item 10 "
                                  "(giekf_infer_batch)")
    cfg = config if config is not None else config_cls(**cfg_kwargs)
    if ihgp:
        return ihgp_infer_batch(model, paramsB, yB, maskB, cfg, device=device)
    return ep_infer_batch(model, paramsB, yB, maskB, cfg, device=device)
