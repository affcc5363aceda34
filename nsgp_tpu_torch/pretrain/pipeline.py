"""End-to-end GT-NMF initialization pipeline (training without fminunc).

Port of ``nsgp_tpu/pretrain/pipeline.py`` (ref
experiments/train_GTFNMF_fixed_params.m, the pipeline the paper's
experiment scripts call):

    fit_probSTFT_SD  ->  kernel_ss_probFB  ->  GPPAD  ->  nmf_fp
                     ->  trainSEGP_RS      ->  trained params artifact

Stage mapping (ref train_model.m:85-149):
  1. fit_probstft      : D spectral-mixture components from the Welch
                         spectrum (Whittle ML, coarse-to-fine).
  2. steady_filterbank : complex subband coefficients Z (steady Kalman).
  3. demodulate        : positive envelopes of real(Z) at timescale fs/10.
  4. nmf_fp            : N nonnegative temporal components + weights W,
                         ordered fastest-first.
  5. fit_segp          : modulator (variance, lengthscale) from the
                         inverse-softplus NMF components.

Artifacts are ``.npz`` files with the JAX package's keys: either package
reads what the other writes.  ``load_trained`` is ``convert.load_trained``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as Fn

from nsgp_tpu_torch.convert import load_trained  # noqa: F401  (re-exported)
from nsgp_tpu_torch.models.gtnmf import PARAM_NAMES, GTNMFModel, GTNMFParams
from nsgp_tpu_torch.ops.moments import softplus
from nsgp_tpu_torch.pretrain import filterbank as fb_mod
from nsgp_tpu_torch.pretrain import gppad, nmf, segp, spectral
from nsgp_tpu_torch.utils.device import resolve_device


class TrainedModel(NamedTuple):
    model: GTNMFModel
    params: GTNMFParams
    envelopes: Optional[torch.Tensor]  # (T, D) GPPAD envelopes (diagnostic)
    H: Optional[torch.Tensor]  # (T, N) NMF components (diagnostic)
    # Stationary spectral fit from stage 1 (the denoising Wiener baseline
    # reuses it).  None on artifacts saved before this field existed.
    fit: object = None
    normaliser: float = 1.0  # ref train_GTFNMF_fixed_params.m:14
    fs: float = 16000.0


def _inv_softplus(x):
    # stable inverse of log(1 + exp(.))
    return torch.where(x > 20.0, x, torch.log(torch.expm1(torch.clamp_min(x, 1e-8))))


def train_gtnmf_fixed_params(
    y,
    D: int = 16,
    N: int = 3,
    kernel1: str = "matern32",
    kernel2: str = "matern52",
    variant: str = "sq",
    fs: float = 16000.0,
    p_cubature: int = 9,
    seed: int = 0,
    filterbank_kwargs: Optional[dict] = None,
    generator: Optional[torch.Generator] = None,
    nmf_init=None,
    device=None,  # None = the card; "cpu" as asked
) -> TrainedModel:
    """Initialize a GT-NMF model from a raw signal, no likelihood opt.

    Equivalent call: train_GTFNMF_fixed_params(y, D, N, kernel, ...).  The
    NMF's 8 random starts come from ``generator`` (default: seeded with
    ``seed`` on the device) or are given as ``nmf_init`` (``nmf.nmf_fp``'s
    ``init``)."""
    dev = resolve_device(device)
    y = torch.as_tensor(y).to(dev)
    y = y / y.std(correction=0)
    T = y.shape[0]

    # 1. spectral-mixture filterbank fit (coarse-to-fine Whittle), staged
    #    exp -> kernel1, with dead-component reassignment and exit variance
    #    rescaling (fit_probSTFT_SD.m)
    fbkw = dict(num_levels=3, steps_per_level=400)
    fbkw.update(filterbank_kwargs or {})
    fit = spectral.fit_probstft_staged(y, D, kernel=kernel1, device=dev, **fbkw)
    sub_len = fit.lengthscales(kernel1)

    # 2. steady-state Kalman filterbank transform.  The reference passes
    #    vary = 0 here (train_GTFNMF_fixed_params.m:64); the steady path needs
    #    a positive noise for the DARE, so the fitted noise is floored.
    fb = fb_mod.build_filterbank(fit.sigma2, sub_len, fit.omega, kernel=kernel1,
                                 noise=torch.clamp_min(fit.noise, 1e-6), device=dev)
    Z = fb_mod.steady_filterbank(fb, y, device=dev).Z  # (T, D) complex

    # 3. GPPAD envelopes at timescale fs/10 samples (ref train_model.m:105)
    env = gppad.demodulate_channels(Z.real.to(y.dtype), ell=float(fs) / 10.0, steps=400,
                                    device=dev).envelope  # (T, D)

    # 4. NMF of the envelopes -> W (D, N), H (T, N)
    #    (train_GTFNMF_fixed_params.m:82 `nmf_fp(mods, ...)`)
    if generator is None and nmf_init is None:
        generator = torch.Generator(dev).manual_seed(seed)
    res = nmf.nmf_fp(env, N, iters=200, restarts=8, generator=generator, init=nmf_init,
                     device=dev)
    H, W = nmf.order_by_fastness(res.H, res.W)
    # normalize components to mean 1 (scale absorbed into W)
    scale = H.mean(0)
    H = H / scale[None, :]
    W = W * scale[None, :]

    # 5. SE-GP Whittle fits to the thresholded, smoothed, mean-subtracted
    #    log-latents (:95-111): softplus^-1(H + 1e-2), smoothed by the
    #    softplus-bump filter over x in [-100, 100] (np.convolve "same"),
    #    mean removed; (var, len) scaled by 1.5 at save time (:127).
    g_lat = _inv_softplus(H + 1e-2)
    x = torch.arange(-100, 101, dtype=y.dtype, device=dev)
    filt = softplus(-0.5 * x**2)
    filt = filt / filt.sum()
    # conv1d correlates: the flipped filter convolves
    g_sm = Fn.conv1d(g_lat.T[:, None, :], filt.flip(0)[None, None, :], padding=100)[:, 0].T
    fits = segp.fit_segp((g_sm - g_sm.mean(0)).T, device=dev)  # the N fits at once
    mod_var = 1.5 * fits.var
    mod_len = torch.clamp(1.5 * fits.ell, 10.0, T / 2.0)

    model = GTNMFModel(D=D, N=N, kernel1=kernel1, kernel2=kernel2, variant=variant,
                       p_cubature=p_cubature)
    params = GTNMFParams(
        # Experiments set their own w_lik (denoising: the noise level,
        # missing data: small); the floored fit noise is only a default.
        lik=torch.clamp_min(fit.noise, 1e-4),
        # The reference saves FIXED subband variances 0.06, not the fitted
        # ones; modulation absorbs the scale (:126 `param1 = 0.06*ones`).
        sub_var=torch.full((D,), 0.06, dtype=y.dtype, device=dev),
        sub_len=sub_len,
        omega=fit.omega,
        mod_var=mod_var,
        mod_len=mod_len,
        W=W,
    )
    return TrainedModel(model=model, params=params, envelopes=env, H=H, fit=fit, fs=float(fs))


def save_trained(path: str, tm: TrainedModel) -> None:
    """Write the artifact with ``nsgp_tpu.pretrain.pipeline.save_trained``'s
    keys (the stage-1 fit as ``fb_*`` when present)."""
    host = lambda x: x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    extra = {}
    if tm.fit is not None:
        extra = dict(fb_sigma2=host(tm.fit.sigma2), fb_lam=host(tm.fit.lam),
                     fb_omega=host(tm.fit.omega), fb_noise=host(tm.fit.noise))
    np.savez(
        path,
        D=tm.model.D, N=tm.model.N,
        kernel1=tm.model.kernel1, kernel2=tm.model.kernel2,
        variant=tm.model.variant, p_cubature=tm.model.p_cubature,
        **{k: host(v) for k, v in zip(PARAM_NAMES, tm.params.leaves())},
        normaliser=float(tm.normaliser),
        fs=float(tm.fs),
        **extra,
    )
