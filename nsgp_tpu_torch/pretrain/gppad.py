"""GP probabilistic amplitude demodulation (GPPAD), MAP path.

Port of ``nsgp_tpu/pretrain/gppad.py`` (ref matlab/experiments/gppad/:
GPPAD.m, GPModelFast/MAPGPFast.m, GetGPObjFast.m, GetFFTCovFast.m): the MAP
demodulation the training pipeline calls (train_model.m:105-113).

Model per channel:  y_t = c_t * a(x_t),  c_t ~ N(0, vary),
                    a = softplus link,  x ~ GP(0, SE kernel, lengthscale ell)

MAP objective, x in whitened FFT coordinates u (x = irfft(sqrt(S T) u)):

    J(u) = sum_t [ 0.5 y_t^2 / (vary a_t^2) + log a_t ] + 0.5 |u|^2

optimised by Adam (``pretrain.adam``) on the stacked real and imaginary parts
of u, whose complex dtype follows y's (complex128 with float64).  D channels
are one tensor (D, T//2+1) of unknowns: the channels' objectives are summed,
which leaves each channel's gradient and elementwise Adam step its own.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from nsgp_tpu_torch.ops.moments import softplus
from nsgp_tpu_torch.pretrain.adam import adam
from nsgp_tpu_torch.utils.device import resolve_device


def se_spectrum(T: int, ell: float, var: float, dtype=torch.float64, device=None):
    """rfft eigenvalues of the circulant SE covariance on a length-T grid."""
    freqs = torch.arange(T // 2 + 1, dtype=dtype, device=device) * (2.0 * math.pi / T)
    # SE spectral density: var * sqrt(2 pi) ell exp(-ell^2 w^2 / 2)
    S = var * math.sqrt(2.0 * math.pi) * ell * torch.exp(-0.5 * (ell * freqs) ** 2)
    return torch.clamp_min(S, 1e-12)


class GPPADResult(NamedTuple):
    envelope: torch.Tensor  # (T,) or (T, D) positive amplitude a(x)
    carrier: torch.Tensor  # (T,) or (T, D) y / a(x)
    x: torch.Tensor  # latent GP path(s)
    obj: torch.Tensor  # final MAP objective, () or (D,)


def _map_objective(u, y, S, vary):
    """Per-channel objective (B,) and envelopes (B, T); u (B, F) complex."""
    T = y.shape[-1]
    x = torch.fft.irfft(torch.sqrt(S * T) * u, n=T)
    a = softplus(x)
    lik = torch.sum(0.5 * y * y / (vary * a * a) + torch.log(a), -1)
    return lik + 0.5 * torch.sum(torch.abs(u) ** 2, -1), a


def _demodulate(Y, ell: float, steps: int, lr: float) -> GPPADResult:
    """MAP demodulation of the rows of Y (B, T); fields with a leading B."""
    B, T = Y.shape
    vary = Y.var(-1, correction=0, keepdim=True)
    S = se_spectrum(T, ell, 1.0, Y.dtype, Y.device)
    ri0 = torch.zeros((B, 2, T // 2 + 1), dtype=Y.dtype, device=Y.device)
    u_of = lambda ri: torch.complex(ri[:, 0], ri[:, 1])
    (ri,), _ = adam(lambda ri: _map_objective(u_of(ri), Y, S, vary)[0], [ri0], lr, steps)
    u = u_of(ri)
    obj, a = _map_objective(u, Y, S, vary)
    x = torch.fft.irfft(torch.sqrt(S * T) * u, n=T)
    return GPPADResult(envelope=a, carrier=Y / a, x=x, obj=obj)


def demodulate(y, ell: float, steps: int = 600, lr: float = 5e-2,
               device=None) -> GPPADResult:
    """MAP amplitude demodulation of one channel, y (T,).

    Equivalent of GPPAD's MAPGPFast; ``ell`` is the demodulation timescale
    in samples (the pipeline uses fs/10)."""
    y = torch.as_tensor(y).to(resolve_device(device))
    res = _demodulate(y[None], ell, steps, lr)
    return GPPADResult(*(f[0] for f in res))


def demodulate_channels(Y, ell: float, steps: int = 600, lr: float = 5e-2,
                        device=None) -> GPPADResult:
    """Demodulate D channels at once, Y (T, D): envelope, carrier and x
    (T, D), obj (D,)."""
    Y = torch.as_tensor(Y).to(resolve_device(device))
    res = _demodulate(Y.T, ell, steps, lr)
    return GPPADResult(envelope=res.envelope.T, carrier=res.carrier.T, x=res.x.T, obj=res.obj)


def laplace_evidence(y, ell: float, steps: int = 400, lr: float = 5e-2,
                     device=None) -> torch.Tensor:
    """Approximate log evidence of the demodulation timescale ``ell``.

    The MAP objective plus a circulant (average-curvature) Laplace volume
    term (ref GPModelFast/Laplace/GetLaplaceObjGPPAD*.m, there a Lanczos
    log-det): with c_t = d^2 nll / dx_t^2 at the MAP,

        log |H| ~= sum_k mult_k log(1 + T * S_k * max(mean_t c_t, 0)),

    mult_k counting each non-DC / non-Nyquist rfft bin twice."""
    y = torch.as_tensor(y).to(resolve_device(device))
    res = demodulate(y, ell, steps, lr, device=y.device)
    T = y.shape[0]
    vary = y.var(correction=0)
    S = se_spectrum(T, ell, 1.0, y.dtype, y.device)

    # curvature of nll(x) = 0.5 y^2 / (vary a^2) + log a, a = softplus(x)
    a = softplus(res.x)
    s = torch.sigmoid(res.x)  # a'
    s2 = s * (1.0 - s)  # a''
    r = y * y / vary
    c = 3.0 * r * s * s / a**4 - r * s2 / a**3 + s2 / a - s * s / (a * a)
    cbar = torch.clamp_min(c.mean(), 0.0)
    mult = torch.full(S.shape, 2.0, dtype=y.dtype, device=y.device)
    mult[0] = 1.0
    if T % 2 == 0:
        mult[-1] = 1.0
    logdet = torch.sum(mult * torch.log1p(S * T * cbar))
    return -res.obj - 0.5 * logdet


def learn_lengthscale(y, ells, steps: int = 400, lr: float = 5e-2, device=None):
    """Grid-search the demodulation timescale by approximate evidence (ref
    LearnLengthsGPPAD); returns (best_ell, evidences (len(ells),))."""
    evs = torch.stack([laplace_evidence(y, float(e), steps, lr, device) for e in ells])
    return float(ells[int(torch.argmax(evs))]), evs
