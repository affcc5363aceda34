"""SE-GP spectral (Whittle) fits for modulator hyperparameters.

Port of ``nsgp_tpu/pretrain/segp.py`` (ref matlab/experiments/toolsGP/
trainSEGP_RS.m): fit the (variance, lengthscale) of an SE GP to a regularly
sampled signal by maximizing the spectral-domain (Whittle) likelihood

    -0.5 sum_k [ log S(w_k) + I(w_k) / S(w_k) ]

with I the periodogram and S the SE spectral density plus a small noise
floor, by Adam (``pretrain.adam``).  Sets the modulator lengthscales and
variances from smoothed log-NMF components (train_model.m:136-149).  Several
signals (B, T) are fitted at once: their objectives are summed, which leaves
each fit's gradient and elementwise Adam step its own.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from nsgp_tpu_torch.pretrain.adam import adam
from nsgp_tpu_torch.utils.device import resolve_device


class SEGPFit(NamedTuple):
    var: torch.Tensor  # () or (B,)
    ell: torch.Tensor  # lengthscale in samples
    noise: torch.Tensor
    obj: torch.Tensor  # objective at the start of the last step, as JAX's vals[-1]


def _se_spec(var, ell, w):
    return var * math.sqrt(2.0 * math.pi) * ell * torch.exp(-0.5 * (ell * w) ** 2)


def fit_segp(y, steps: int = 500, lr: float = 5e-2, device=None) -> SEGPFit:
    """Whittle-ML fit of SE-GP (var, ell) to a signal y (T,), or to each row
    of y (B, T) (fields (B,))."""
    y = torch.as_tensor(y).to(resolve_device(device))
    y = y - y.mean(-1, keepdim=True)
    T = y.shape[-1]
    I = torch.fft.rfft(y).abs() ** 2 / T
    w = torch.arange(T // 2 + 1, dtype=y.dtype, device=y.device) * (2.0 * math.pi / T)
    I, w = I[..., 1:], w[1:]  # drop DC

    vy = y.var(-1, correction=0)
    p0 = torch.log(torch.stack([vy, torch.full_like(vy, T / 20.0), vy * 1e-2], -1))

    def nll(p):
        var, ell, noise = torch.exp(p).unbind(-1)
        S = _se_spec(var[..., None], ell[..., None], w) + noise[..., None]
        return torch.sum(torch.log(S) + I / S, -1)

    (p,), obj = adam(nll, [p0], lr, steps)
    var, ell, noise = torch.exp(p).unbind(-1)
    return SEGPFit(var=var, ell=ell, noise=noise, obj=obj)
