"""Evaluation metrics: RMSE and SNR, optionally over a mask.

Port of ``rmse`` and ``snr_db`` of ``nsgp_tpu/utils/metrics.py``.  A leading
file axis is reduced per file (the last axis is time).
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
