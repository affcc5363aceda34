"""Legacy AR(2) probabilistic filterbank (Turner's thesis, ch. 5).

Port of ``nsgp_tpu/pretrain/ar2.py`` (ref prob_filterbank/fitAR2FB.m,
cosFreq2AR2.m, getSpecAR2cosFreq.m, getmVarAR2.m, ar2LDSParams.m,
samplePFB.m): D independent AR(2) processes

    x_{d,t} = lam1_d x_{d,t-1} + lam2_d x_{d,t-2} + sqrt(Var_d) eps,
    y_t     = sum_d x_{d,t} + noise,

fitted by Whittle spectrum matching in the stationarity-safe (cosCF, cosDF,
mVar) parameterization (fitAR2FB.m:49-66), by the Adam of ``pretrain.adam``
with all D processes one batched objective.  The kernel-based path
(``spectral`` + ``filterbank``) supersedes it in the paper pipeline.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from nsgp_tpu_torch.ops.pscan import affine_combine, associative_scan
from nsgp_tpu_torch.pretrain.adam import adam
from nsgp_tpu_torch.pretrain.spectral import welch
from nsgp_tpu_torch.utils.device import resolve_device


def cosfreq_to_ar2(cosCF, cosDF, mVar):
    """(cosCF, cosDF, mVar) -> (Lam (D, 2), Var (D,)).

    Ref cosFreq2AR2.m, the closed-form inverse of the cosine-frequency
    parameterization; valid for |cosCF| < 1, cosDF > 0 (stationary)."""
    a1 = cosDF**2 + 4.0 * cosCF**2
    a2 = -2.0 * cosDF**2 + 8.0 * cosCF**2 - 2.0
    z2 = -a1 / 2.0 - torch.sqrt(torch.clamp_min(a1**2 / 4.0 - a2 + 2.0, 0.0))
    lam2 = (z2 + torch.sqrt(torch.clamp_min(z2**2 - 4.0, 0.0))) / 2.0
    lam1 = 4.0 * cosCF * lam2 / (lam2 - 1.0)
    var = mVar * (1.0 - lam1**2 - lam2**2 - lam2 - lam1**2 * lam2 + lam2**3) / (1.0 - lam2)
    return torch.stack([lam1, lam2], -1), var


def ar2_marginal_var(Lam, Var):
    """<x_t^2> of an AR(2) process (ref getmVarAR2.m)."""
    lam1, lam2 = Lam[..., 0], Lam[..., 1]
    return (1.0 - lam2) * Var / (1.0 - lam1**2 - lam2**2 - lam2 - lam1**2 * lam2 + lam2**3)


def ar2_component_spectra(Lam, Var, omega):
    """Per-process power spectral density at ``omega`` (rad/sample):
    S_d(w) = Var_d / |1 - lam1 e^{-iw} - lam2 e^{-2iw}|^2 (the process
    variance is (1/2pi) * integral of S over [-pi, pi]; ref
    getSpecAR2cosFreq.m).  Lam (D, 2), Var (D,), omega (F,) -> (F, D)."""
    w = omega[:, None]
    lam1, lam2 = Lam[None, :, 0], Lam[None, :, 1]
    denom = (1.0 + lam1**2 + lam2**2 - 2.0 * lam1 * (1.0 - lam2) * torch.cos(w)
             - 2.0 * lam2 * torch.cos(2.0 * w))
    return Var[None, :] / torch.clamp_min(denom, 1e-12)


class AR2Fit(NamedTuple):
    Lam: torch.Tensor  # (D, 2) dynamical weights
    Var: torch.Tensor  # (D,) innovation variances
    cosCF: torch.Tensor  # (D,)
    cosDF: torch.Tensor  # (D,)
    mVar: torch.Tensor  # (D,)
    obj: torch.Tensor  # final Whittle objective


def fit_ar2fb(
    y,
    D: int,
    vary: float = 1e-3,
    num_levels: int = 3,
    steps_per_level: int = 300,
    min_win: int = 128,
    max_win: int = 1024,
    learning_rate: float = 3e-2,
    cdf_min: float = 1e-3,
    device=None,
) -> AR2Fit:
    """Coarse-to-fine Whittle fit of an AR(2) filterbank (ref fitAR2FB.m):
    the Welch window annealed from short to long, Adam on (atanh cosCF,
    log cosDF, log mVar) at each level."""
    y = torch.as_tensor(y).to(resolve_device(device))
    dt_, dev = y.dtype, y.device

    # init: spread center frequencies, moderate bandwidths, equal share of
    # the signal variance (ref fitAR2FB.m:91-98)
    cf0 = np.arange(1, D + 1) / (2.0 * (D + 1))
    t = lambda x: torch.as_tensor(x, dtype=dt_, device=dev)
    theta = torch.cat([
        torch.arctanh(t(np.cos(2.0 * np.pi * cf0) * 0.999)),
        torch.log(t(np.full(D, 0.05))),
        torch.log(t(np.full(D, float(y.var(correction=0)) / D))),
    ])

    def unpack(th):
        cosCF = torch.tanh(th[:D]) * (1.0 - 2.0 * cdf_min)
        cosDF = torch.exp(th[D: 2 * D]) + cdf_min
        mVar = torch.exp(th[2 * D:])
        return cosCF, cosDF, mVar

    def whittle(th, freq, target):
        Lam, Var = cosfreq_to_ar2(*unpack(th))
        S = ar2_component_spectra(Lam, Var, freq).sum(-1) + vary
        return torch.sum(torch.log(S) + target / S)

    wins = np.geomspace(min_win, max_win, num_levels).astype(int) // 2 * 2
    obj = torch.zeros((), dtype=dt_, device=dev)
    for win in wins:
        freq, target = welch(y, int(win))
        # drop DC (the reference fits strictly positive frequencies)
        (theta,), obj = adam(lambda th: whittle(th, freq[1:], target[1:]), [theta],
                             learning_rate, steps_per_level)
    cosCF, cosDF, mVar = unpack(theta)
    Lam, Var = cosfreq_to_ar2(cosCF, cosDF, mVar)
    return AR2Fit(Lam=Lam, Var=Var, cosCF=cosCF, cosDF=cosDF, mVar=mVar, obj=obj)


def ar2_lds_params(Lam, Var, vary):
    """Companion-form LDS of the AR(2) bank (ref ar2LDSParams.m): per process
    a 2-state block [lam1 lam2; 1 0] with innovation variance on the first
    state, emission picking state 1 of every block, and the stationary prior
    from the lag-0/1 autocovariances.

    Returns (A (2D, 2D), Q (2D, 2D), C (1, 2D), R, x0 (2D,), P0 (2D, 2D))."""
    D = Var.shape[0]
    lam1, lam2 = Lam[:, 0], Lam[:, 1]
    mVar = ar2_marginal_var(Lam, Var)
    rho1 = lam1 / (1.0 - lam2) * mVar  # Yule-Walker lag-1 autocovariance
    blocks_A = torch.stack([torch.stack([lam1, lam2], -1),
                            torch.stack([torch.ones_like(lam1), torch.zeros_like(lam1)], -1)],
                           -2)  # (D, 2, 2)
    A = torch.block_diag(*blocks_A)
    Q = torch.zeros((2 * D, 2 * D), dtype=Var.dtype, device=Var.device)
    Q[2 * torch.arange(D), 2 * torch.arange(D)] = Var
    C = torch.tensor([1.0, 0.0], dtype=Var.dtype, device=Var.device).repeat(D)[None, :]
    blocks_P0 = torch.stack([torch.stack([mVar, rho1], -1), torch.stack([rho1, mVar], -1)], -2)
    P0 = torch.block_diag(*blocks_P0)
    return (A, Q, C, torch.as_tensor(vary, dtype=Var.dtype, device=Var.device),
            torch.zeros((2 * D,), dtype=Var.dtype, device=Var.device), P0)


def sample_pfb(Lam, Var, T: int, vary: float = 0.0, eps=None, obs_noise=None,
               generator: Optional[torch.Generator] = None, device=None):
    """Sample the AR(2) filterbank (ref samplePFB.m): returns (y (T,), X (T,
    D)), the channels and their noisy sum.

    The standard normal draws are ``eps`` (T, D) for the innovations and
    ``obs_noise`` (T,) for the observation noise, else drawn from
    ``generator`` (default seed 0).  The recursion is a linear LDS in the
    companion state (x_t, x_{t-1}), run by ``ops.pscan.associative_scan``."""
    dev = resolve_device(device)
    Lam, Var = torch.as_tensor(Lam).to(dev), torch.as_tensor(Var).to(dev)
    D = Var.shape[0]
    dt_ = Var.dtype
    if generator is None:
        generator = torch.Generator(dev).manual_seed(0)
    draw = lambda shape: torch.randn(shape, generator=generator, dtype=dt_,
                                     device=generator.device)
    eps = draw((T, D)) if eps is None else eps
    e = torch.as_tensor(eps).to(dev, dt_) * torch.sqrt(Var)[None, :]

    # s_t = M s_{t-1} + (e_t, 0), s = (x_t, x_{t-1}) per process, s_{-1} = 0
    M = torch.zeros((D, 2, 2), dtype=dt_, device=dev)
    M[:, 0] = Lam
    M[:, 1, 0] = 1.0
    c = torch.stack([e, torch.zeros_like(e)], -1)  # (T, D, 2)
    _, s = associative_scan(affine_combine, (M.expand(T, D, 2, 2), c))
    X = s[..., 0]
    y = X.sum(-1)
    if vary > 0.0:
        noise = draw((T,)) if obs_noise is None else obs_noise
        y = y + math.sqrt(vary) * torch.as_tensor(noise).to(dev, dt_)
    return y, X
