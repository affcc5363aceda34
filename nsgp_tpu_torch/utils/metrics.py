"""Evaluation metrics: RMSE, SNR, log-spectrogram SNR with loudness floor.

Port of ``nsgp_tpu/utils/metrics.py`` (ref demo_stationary_filterbank.m:
204-226, missing_data_music_results.m:26-37, prob_filterbank/loud_floor.m).
``rmse`` and ``snr_db`` reduce a leading file axis per file (the last axis is
time); the spectrogram metrics take one signal.  Everything runs where its
tensors are.
"""

from __future__ import annotations

import torch


def rmse(a, b, mask=None):
    d = (a - b) ** 2
    if mask is not None:
        return torch.sqrt(torch.where(mask, d, torch.zeros_like(d)).sum(-1) / mask.sum(-1))
    return torch.sqrt(d.mean(-1))


def snr_db(clean, estimate, mask=None):
    """Signal-to-noise ratio of the estimate vs the clean signal (dB)."""
    err = (clean - estimate) ** 2
    sig = clean**2
    if mask is not None:
        err = torch.where(mask, err, torch.zeros_like(err))
        sig = torch.where(mask, sig, torch.zeros_like(sig))
    return 10.0 * torch.log10(sig.sum(-1) / torch.clamp_min(err.sum(-1), 1e-300))


def loud_floor(S, floor_db: float = -80.0):
    """Floor a power spectrogram before taking logs
    (ref prob_filterbank/loud_floor.m)."""
    return torch.maximum(S, S.max() * 10.0 ** (floor_db / 10.0))


def frames(y, nwin: int, hop: int):
    """Frame indices (nfrm, nwin) of the whole hops of y (at least one)."""
    nfrm = max(1, (y.shape[0] - nwin) // hop + 1)
    return (torch.arange(nwin, device=y.device)[None, :]
            + hop * torch.arange(nfrm, device=y.device)[:, None])


def _spectrogram(y, nwin: int = 256, hop: int = 128):
    """|rfft|^2 of the symmetric-Hann-windowed frames (``jnp.hanning``)."""
    win = torch.hann_window(nwin, periodic=False, dtype=y.dtype, device=y.device)
    return torch.fft.rfft(y[frames(y, nwin, hop)] * win[None], dim=-1).abs() ** 2


def log_spec_snr_db(clean, estimate, nwin: int = 256, hop: int = 128,
                    floor_db: float = -80.0):
    """Log-spectrogram SNR with loudness floor
    (ref demo_stationary_filterbank.m:204-226)."""
    Sc = torch.log(loud_floor(_spectrogram(clean, nwin, hop), floor_db))
    Se = torch.log(loud_floor(_spectrogram(estimate, nwin, hop), floor_db))
    num = torch.sum((Sc - Sc.mean()) ** 2)
    den = torch.clamp_min(torch.sum((Sc - Se) ** 2), 1e-300)
    return 10.0 * torch.log10(num / den)
