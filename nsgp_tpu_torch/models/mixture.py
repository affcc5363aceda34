"""Mixture-of-models assembly for source separation.

Port of ``nsgp_tpu/models/mixture.py`` (ref gf_ep_mods_nmf_mixture.m:90-128):
J pre-trained GT-NMF models are stacked, subbands first, then modulators,
with block-diagonal NMF weights, and the standard engines run unchanged on
the joint model against the mixture signal.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from nsgp_tpu_torch.models.gtnmf import GTNMFModel, GTNMFParams
from nsgp_tpu_torch.ops.moments import LINKS


class SourceSlices(NamedTuple):
    """Channel index ranges of each source inside the joint model."""

    sub: tuple  # tuple of (start, stop) into the subband block [0, D_tot)
    mod: tuple  # tuple of (start, stop) into the modulator block [0, N_tot)


def join_models(models: Sequence[GTNMFModel], params: Sequence[GTNMFParams],
                lik: Optional[float] = None):
    """Stack J models into one joint GT-NMF model.

    Returns (joint_model, joint_params, slices).  All models must share
    kernels/link/variant.  ``lik`` is the explicit mixture observation-noise
    variance (the reference passes one, source_sep_piano.m:84-88); if None,
    the mean of the sources' trained noises.
    """
    m0 = models[0]
    for m in models[1:]:
        if (m.kernel1, m.kernel2, m.link, m.variant) != (
                m0.kernel1, m0.kernel2, m0.link, m0.variant):
            raise ValueError("mixture models must share kernels/link/variant")

    joint_model = m0._replace(D=sum(m.D for m in models), N=sum(m.N for m in models))
    lik0 = params[0].lik
    if lik is None:
        lik_j = torch.stack([p.lik for p in params]).mean()
    else:
        lik_j = torch.as_tensor(lik, dtype=lik0.dtype, device=lik0.device)
    cat = lambda name: torch.cat([getattr(p, name) for p in params])
    joint_params = GTNMFParams(
        lik=lik_j, sub_var=cat("sub_var"), sub_len=cat("sub_len"), omega=cat("omega"),
        mod_var=cat("mod_var"), mod_len=cat("mod_len"),
        W=torch.block_diag(*[p.W for p in params]),
    )

    sub_sl, mod_sl = [], []
    d = n = 0
    for m in models:
        sub_sl.append((d, d + m.D))
        mod_sl.append((n, n + m.N))
        d += m.D
        n += m.N
    return joint_model, joint_params, SourceSlices(tuple(sub_sl), tuple(mod_sl))


def channel_contributions(model: GTNMFModel, params: GTNMFParams, Eft, Varft=None,
                          generator: Optional[torch.Generator] = None, n_samples: int = 0):
    """Posterior estimate of each subband's contribution a_d z_d, (T, D).

    With ``n_samples`` == 0 (or no variances / generator) the plug-in posterior
    mean; otherwise Monte-Carlo over the channel-factorized marginals
    (ref missing_data_music.m:170-175, source_sep_piano.m:210-227).  The noise
    is drawn from ``generator`` on its own device, subbands first, and moved
    to the moments' device.
    """
    D = model.D
    link = LINKS[model.link]

    def amps(g):  # (..., N) -> (..., D)
        a = link(g) @ params.W.T
        if model.variant == "sq":
            a = torch.sqrt(torch.clamp_min(a, 1e-12))
        return a

    z_mu, g_mu = Eft[:, :D], Eft[:, D:]
    if not (n_samples and Varft is not None and generator is not None):
        return z_mu * amps(g_mu)

    def draw(mu, var):
        eps = torch.randn((n_samples,) + mu.shape, generator=generator, dtype=mu.dtype,
                          device=generator.device).to(mu.device)
        return mu[None] + torch.sqrt(torch.clamp_min(var, 0.0))[None] * eps

    z = draw(z_mu, Varft[:, :D])
    g = draw(g_mu, Varft[:, D:])
    return (z * amps(g)).mean(0)


def source_signals(joint_model: GTNMFModel, joint_params: GTNMFParams, slices: SourceSlices,
                   Eft, Varft=None, generator: Optional[torch.Generator] = None,
                   n_samples: int = 0):
    """Per-source posterior signal estimates s_j = sum_{d in source j} a_d z_d,
    (T, J), with a from the joint modulators (see ``channel_contributions``)."""
    contrib = channel_contributions(joint_model, joint_params, Eft, Varft, generator,
                                    n_samples)
    return torch.stack([contrib[:, lo:hi].sum(-1) for lo, hi in slices.sub], dim=-1)
