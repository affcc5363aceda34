"""Denoising: set the observation noise to the (known or estimated)
corruption level and read off the posterior signal.

Port of ``nsgp_tpu/apps/denoise.py`` (ref experiments/
noise_reduction_speech.m): white noise of variance v is added (yTest = y +
sqrt(v) xi, :63), the model's likelihood noise w_lik is set to v, inference
runs unchanged, and the denoised signal is the posterior reconstruction or
the time-varying Wiener read-out (``tv_wiener``).  Metrics: SNR vs the clean
signal.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from nsgp_tpu_torch.apps.missing_data import reconstruct_signal
from nsgp_tpu_torch.models.gtnmf import GTNMFModel, GTNMFParams
from nsgp_tpu_torch.ops.moments import LINKS
from nsgp_tpu_torch.pretrain.spectral import LAM_SCALE, component_spectra
from nsgp_tpu_torch.utils import metrics
from nsgp_tpu_torch.utils.device import resolve_device


class DenoiseResult(NamedTuple):
    y_hat: torch.Tensor
    snr_in: torch.Tensor  # () input SNR (noisy vs clean), dB
    snr_out: torch.Tensor  # () output SNR (denoised vs clean), dB
    result: object


def _unit_spectra(kernel: str, lengthscales, omega, nwin: int, dtype):
    """(F, D) per-channel spectra at the rfft bins of an nwin-point frame,
    each normalized to mean 1 over the TWO-SIDED grid (the discrete PSD
    convention in which white noise of variance v has flat PSD v)."""
    wbins = torch.arange(nwin // 2 + 1, dtype=dtype, device=omega.device) * (
        2.0 * math.pi / nwin)
    lam = LAM_SCALE[kernel] / lengthscales
    P = component_spectra(kernel, torch.ones_like(lam), lam, omega, wbins)
    two_sided = torch.cat([P, P[1:-1].flip(0)])
    return P / two_sided.mean(0, keepdim=True)


def tv_wiener(
    model: GTNMFModel,
    params: GTNMFParams,
    Eft: torch.Tensor,  # (T, C) posterior observable means
    y_noisy: torch.Tensor,  # (T,)
    noise_var: float,
    nwin: int = 512,
    hop: int = 128,
    stat_spec: Optional[torch.Tensor] = None,  # (F,) stationary signal spectrum
    # at the rfft bins (same PSD units as noise_var), e.g. from the stage-1 fit
    stat_floor: float = 0.0,  # kappa: G = max(G_tv, kappa * G_stat)
):
    """Time-varying Wiener filter from the posterior modulator envelopes.

    Conditional on the modulator posterior, the model's local signal
    spectrum at frame tau is

        S_tau(w) = sum_d [W E link(g_tau)]_d * sub_var_d * P_d(w),

    with P_d the unit-variance spectral-mixture component ('sq' variant:
    [W link g]_d multiplies z_d's VARIANCE), and the MMSE gain
    G_tau(w) = S_tau(w) / (S_tau(w) + v) is applied to the noisy STFT.
    ``stat_floor`` bounds how much harder than the stationary Wiener gain
    the filter may suppress (0 = the pure time-varying gain).  sqrt-Hann
    analysis/synthesis windows (the periodic Hann window), overlap-added by
    ``index_add_``; COLA at hop = nwin/4.  Runs where ``Eft`` is."""
    D = model.D
    T = y_noisy.shape[0]
    dtype, dev = y_noisy.dtype, y_noisy.device

    # local per-channel variance multipliers (T, D)
    a2 = LINKS[model.link](Eft[:, D:]) @ params.W.T
    if model.variant != "sq":  # 'amp': s = z * (W link g) -> variance x a^2
        a2 = a2 * a2

    P = _unit_spectra(model.kernel1, params.sub_len, params.omega, nwin, dtype)
    P = P * params.sub_var[None, :]

    win = torch.sqrt(torch.hann_window(nwin, periodic=True, dtype=dtype, device=dev))
    Tp = T + nwin  # zero-pad so the tail is fully covered by frames
    ypad = torch.cat([y_noisy, y_noisy.new_zeros(nwin)])
    a2p = torch.cat([a2, a2[-1:].expand(nwin, D)])
    idx = metrics.frames(ypad, nwin, hop)
    n_frames = idx.shape[0]
    Y = torch.fft.rfft(ypad[idx] * win[None, :], dim=1)  # (n_frames, F)

    # frame-mean envelopes -> local spectra -> gains
    S = a2p[idx].mean(1) @ P.T  # (n_frames, F)
    G = S / (S + noise_var)
    if stat_spec is not None and stat_floor > 0.0:
        G_stat = stat_spec / (stat_spec + noise_var)  # (F,)
        G = torch.maximum(G, stat_floor * G_stat[None, :])
    out_frames = torch.fft.irfft(Y * G, nwin, dim=1) * win[None, :]

    # overlap-add; repeated indices accumulate
    flat = idx.reshape(-1)
    y_out = ypad.new_zeros(Tp).index_add_(0, flat, out_frames.reshape(-1))
    wsum = ypad.new_zeros(Tp).index_add_(0, flat, (win**2).expand(n_frames, nwin).reshape(-1))
    return (y_out / torch.clamp_min(wsum, 1e-6))[:T]


def stationary_spectrum(
    kernel: str,
    sigma2: torch.Tensor,  # (D,) channel variances
    lengthscales: torch.Tensor,  # (D,)
    omega: torch.Tensor,  # (D,)
    nwin: int = 512,
    dtype=torch.float32,
) -> torch.Tensor:
    """(F,) stationary model PSD at the rfft bins, in the discrete-PSD units
    of a white-noise variance (``tv_wiener``'s normalization): the spectrum
    of the stage-1 filterbank fit, for ``tv_wiener``'s ``stat_spec``."""
    P = _unit_spectra(kernel, lengthscales.to(dtype), omega.to(dtype), nwin, dtype)
    return P @ sigma2.to(dtype)


def denoise(
    model: GTNMFModel,
    params: GTNMFParams,
    y_noisy: torch.Tensor,
    noise_var: float,
    y_clean: Optional[torch.Tensor] = None,
    engine: str = "ep",
    generator: Optional[torch.Generator] = None,
    n_samples: int = 20,
    device=None,  # None = the card; "cpu" runs the plain versions
    **engine_kwargs,
) -> DenoiseResult:
    """Run inference with lik = noise_var (ref noise_reduction_speech.m:34-80:
    w_lik is set to the true added-noise level) through ``registry.infer``,
    then reconstruct the signal (plug-in mean, or ``n_samples`` Monte-Carlo
    draws from ``generator``, default seed 0 on the device)."""
    from nsgp_tpu_torch.inference import registry

    dev = resolve_device(device)
    p = params.on(dev)
    p = GTNMFParams(*((torch.full_like(p.lik, noise_var),) + p.leaves()[1:]))
    y_noisy = torch.as_tensor(y_noisy).to(dev)
    res = registry.infer(engine, model, p, y_noisy, None, device=dev, **engine_kwargs)

    if generator is None:
        generator = torch.Generator(dev).manual_seed(0)
    y_hat = reconstruct_signal(model, p, res.Eft, res.Varft, generator, n_samples)
    if y_clean is None:
        nan = torch.full((), float("nan"), dtype=y_hat.dtype, device=dev)
        return DenoiseResult(y_hat=y_hat, snr_in=nan, snr_out=nan, result=res)
    y_clean = torch.as_tensor(y_clean).to(dev)
    return DenoiseResult(y_hat=y_hat, snr_in=metrics.snr_db(y_clean, y_noisy),
                         snr_out=metrics.snr_db(y_clean, y_hat), result=res)
