"""Frequency-weighted segmental SNR, the repo's PESQ stand-in.

Port of ``nsgp_tpu/utils/speech_quality.py``.  The reference evaluates
denoising with PESQ shipped as obfuscated MATLAB p-code (pesq.p), which
cannot be ported by reading; fwSegSNR (Hu & Loizou, "Evaluation of objective
quality measures for speech enhancement", IEEE TASLP 2008, eq. 4) is a
critical-band-weighted per-frame spectral SNR with the standard [-10, 35] dB
clip:

- 25 mel-spaced Gaussian-shaped bands over [50 Hz, fs/2];
- 30 ms frames under the symmetric Hann window (``jnp.hanning``), 75% overlap;
- band weights W = |X_clean|^gamma with gamma = 0.2;
- per-frame band SNR clipped to [-10, 35] dB before averaging.

It runs where its tensors are.
"""

from __future__ import annotations

import math

import torch

from nsgp_tpu_torch.utils.metrics import frames

_GAMMA = 0.2
_SNR_LO, _SNR_HI = -10.0, 35.0
_N_BANDS = 25


def _hz_to_mel(f):
    return 2595.0 * math.log10(1.0 + f / 700.0)


def _band_filters(n_fft: int, fs: float, n_bands: int, dtype, device):
    """(n_bands, n_fft//2+1) Gaussian critical-band filters, mel-spaced."""
    f64 = dict(dtype=torch.float64, device=device)
    freqs = torch.linspace(0.0, fs / 2.0, n_fft // 2 + 1, **f64).to(dtype)
    centers_mel = torch.linspace(_hz_to_mel(50.0), _hz_to_mel(fs / 2.0), n_bands + 2,
                                 **f64)[1:-1]
    centers = (700.0 * (10.0 ** (centers_mel / 2595.0) - 1.0)).to(dtype)
    # bandwidth ~ spacing between neighboring centers (Gaussian sigma = bw/2)
    bw = torch.gradient(centers)[0] + 1e-6
    return torch.exp(-0.5 * ((freqs[None, :] - centers[:, None]) / (0.5 * bw[:, None])) ** 2)


def fw_seg_snr(clean, estimate, fs: int, frame_ms: float = 30.0,
               overlap: float = 0.75) -> torch.Tensor:
    """Frequency-weighted segmental SNR (dB), Hu & Loizou 2008 eq. 4.

    Higher is better; roughly monotone in PESQ MOS for speech enhancement.
    Silent frames contribute through the magnitude weighting (no VAD)."""
    clean = torch.as_tensor(clean)
    estimate = torch.as_tensor(estimate).to(clean.device)
    dtype = clean.dtype
    nwin = int(fs * frame_ms / 1000.0)
    hop = max(1, int(nwin * (1.0 - overlap)))
    idx = frames(clean, nwin, hop)
    win = torch.hann_window(nwin, periodic=False, dtype=dtype, device=clean.device)

    X = torch.fft.rfft(clean[idx] * win[None], dim=-1).abs()
    Xh = torch.fft.rfft(estimate[idx] * win[None], dim=-1).abs()

    filt = _band_filters(nwin, float(fs), _N_BANDS, dtype, clean.device)  # (B, F)
    Xb = X @ filt.T  # (nfrm, B) clean band magnitudes
    Xhb = Xh @ filt.T

    W = Xb**_GAMMA
    num = Xb**2
    den = (Xb - Xhb) ** 2 + 1e-20
    snr = torch.clamp(10.0 * torch.log10(num / den + 1e-20), _SNR_LO, _SNR_HI)
    per_frame = torch.sum(W * snr, -1) / (torch.sum(W, -1) + 1e-20)
    return per_frame.mean()
