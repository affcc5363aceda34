"""Probabilistic filterbank fitting: spectral-mixture components by Whittle ML.

Port of ``nsgp_tpu/pretrain/spectral.py`` (ref fit_probSTFT_SD.m,
get_Obj_pSTFT_*.m, welchMethod.m).  Fits D spectral-mixture components, each
a (Matern-family kernel x cosine) subband with magnitude sigma2_d, bandwidth
lambda_d and center frequency omega_d, to the signal's Welch periodogram by
minimizing the Itakura-Saito / Whittle objective

    Obj = sum_k [ log S_model(w_k) + S_target(w_k) / S_model(w_k) ]

with a coarse-to-fine annealing of the Welch window.  Component spectra are
analytic (the Matern spectral density shifted to +-omega); the optimiser is
the Adam of ``pretrain.adam`` on log/logit-unconstrained parameters.

The dead/duplicate reassignment between levels runs on the host in numpy,
once a level, as in JAX; the spectra it needs come from this module.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from nsgp_tpu_torch.pretrain.adam import adam
from nsgp_tpu_torch.utils.device import resolve_device
from nsgp_tpu_torch.utils.metrics import frames


def welch(y: torch.Tensor, nwin: int, overlap: float = 0.5):
    """Chunked averaged periodogram on [0, pi) (ref welchMethod.m:44-60).

    Returns (omega (nwin//2,), spec (nwin//2,)) with omega in rad/sample.
    The window is the symmetric Hann window of ``jnp.hanning``."""
    hop = max(1, int(nwin * (1.0 - overlap)))
    idx = frames(y, nwin, hop).clamp(0, y.shape[0] - 1)
    win = torch.hann_window(nwin, periodic=False, dtype=y.dtype, device=y.device)
    scale = torch.sum(win**2)
    ps = torch.fft.rfft(y[idx] * win[None, :], dim=-1).abs() ** 2 / scale
    spec = ps.mean(0)[: nwin // 2]
    omega = torch.arange(nwin // 2, dtype=y.dtype, device=y.device) * (2.0 * math.pi / nwin)
    return omega, spec


# Matern spectral densities S(w) for lengthscale-parameterized kernels,
# normalized so that integral S dw / (2 pi) = sigma2.
def _matern_spec(nu_name: str, sigma2, lam, w):
    """lam is the SDE rate (1/ell scaled): exp: 1/ell, m32: sqrt(3)/ell,
    m52: sqrt(5)/ell."""
    if nu_name in ("exp", "matern12"):
        return 2.0 * sigma2 * lam / (lam**2 + w**2)
    if nu_name == "matern32":
        return 4.0 * sigma2 * lam**3 / (lam**2 + w**2) ** 2
    if nu_name == "matern52":
        return (16.0 / 3.0) * sigma2 * lam**5 / (lam**2 + w**2) ** 3
    raise ValueError(f"no analytic spectrum for kernel {nu_name!r}")


LAM_SCALE = {"exp": 1.0, "matern12": 1.0, "matern32": math.sqrt(3.0),
             "matern52": math.sqrt(5.0)}


def component_spectra(kernel: str, sigma2, lam, omega0, w):
    """Per-channel spectral-mixture spectra 0.5 * [S(w - w0) + S(w + w0)].
    Shapes: params (D,), w (F,) -> (F, D)."""
    Sm = lambda wq: _matern_spec(kernel, sigma2[None, :], lam[None, :], wq)
    return 0.5 * (Sm(w[:, None] - omega0[None, :]) + Sm(w[:, None] + omega0[None, :]))


def mixture_spectrum(kernel: str, sigma2, lam, omega0, w):
    """Spectral-mixture spectrum summed over channels: params (D,), w (F,)
    -> (F,)."""
    return component_spectra(kernel, sigma2, lam, omega0, w).sum(-1)


class FilterbankFit(NamedTuple):
    sigma2: torch.Tensor  # (D,) component variances
    lam: torch.Tensor  # (D,) SDE bandwidth rates
    omega: torch.Tensor  # (D,) center frequencies (rad/sample)
    noise: torch.Tensor  # () broadband noise floor
    obj: torch.Tensor  # final objective value

    def lengthscales(self, kernel: str) -> torch.Tensor:
        """Convert rates back to kernel lengthscales (ref lambda_map.m)."""
        return LAM_SCALE[kernel] / self.lam


def _unpack(log_params, D: int):
    """(sigma2, lam, omega0, noise) from the unconstrained vector; omega is
    constrained to (0, pi) by a scaled sigmoid (ref sigmoid.m usage)."""
    return (torch.exp(log_params[:D]), torch.exp(log_params[D: 2 * D]),
            math.pi * torch.sigmoid(log_params[2 * D: 3 * D]), torch.exp(log_params[-1]))


def _whittle_obj(kernel, log_params, w, target, beta):
    D = (log_params.shape[0] - 1) // 3
    sigma2, lam, omega0, noise = _unpack(log_params, D)
    S = mixture_spectrum(kernel, sigma2, lam, omega0, w) + noise
    obj = torch.sum(torch.log(S) + target / S)
    # shrinkage on component variances (ref get_Obj_pSTFT_all.m beta term)
    return obj + beta * torch.sum(sigma2)


def _reassign_dead(
    kernel: str,
    log_params: np.ndarray,
    D: int,
    w: np.ndarray,
    target: np.ndarray,
    var_y: float,
    thresh_frac: float,
):
    """Move dead or duplicate components to the worst-fit frequency.

    Host numpy, copied from the JAX package (ref fit_probSTFT_SD.m:359-415):
    a component whose variance has shrunk below threshold is re-initialized
    at the argmax of log(target) - log(model-without-it), with fresh
    variance/bandwidth (mVar = 1/20 of signal variance, lam = 0.05).  The
    lower-variance member of each pair of components that COLLAPSED ONTO EACH
    OTHER (centers within the narrower bandwidth) is reassigned the same way,
    and a spacing guard keeps one pass from placing several components at
    one frequency.  The spectra come from ``mixture_spectrum`` on the CPU, in
    the parameters' dtype.
    """
    p = np.array(log_params)
    sigma2 = np.exp(p[:D])
    lam = np.exp(p[D: 2 * D])
    omega0 = np.pi / (1.0 + np.exp(-p[2 * D: 3 * D]))
    floor = thresh_frac * var_y / D
    fresh_lam = 0.05
    placed: list = []  # centers assigned THIS pass
    t = torch.as_tensor

    def reassign(d):
        keep = np.arange(D) != d
        S_others = mixture_spectrum(kernel, t(sigma2[keep]), t(lam[keep]), t(omega0[keep]),
                                    t(w)).numpy()
        dspec = np.log(np.maximum(target, 1e-20)) - np.log(np.maximum(S_others, 1e-20))
        # Spacing guard: a freshly placed component is broad (lam 0.05), so a
        # sharp under-fit peak can stay the argmax even after placement.
        for pc in placed:
            dspec[np.abs(w - pc) < fresh_lam] = -np.inf
        if not np.isfinite(dspec).any():
            dspec = np.log(np.maximum(target, 1e-20))
        omega0[d] = float(w[int(np.argmax(dspec))])
        sigma2[d] = var_y / 20.0
        lam[d] = fresh_lam
        placed.append(omega0[d])

    moved = 0
    for d in range(D):
        if sigma2[d] >= floor:
            continue
        reassign(d)
        moved += 1
    # duplicate pairs: centers closer than the NARROWER of the two bandwidths
    for i in range(D):
        for j in range(i + 1, D):
            bw = min(lam[i], lam[j])
            if abs(omega0[i] - omega0[j]) < bw:
                d = i if sigma2[i] <= sigma2[j] else j
                reassign(d)
                moved += 1
    if moved:
        p[:D] = np.log(sigma2)
        p[D: 2 * D] = np.log(lam)
        q = np.clip(omega0 / np.pi, 1e-5, 1 - 1e-5)
        p[2 * D: 3 * D] = np.log(q) - np.log1p(-q)
    return p, moved


def fit_probstft(
    y,
    D: int,
    kernel: str = "exp",
    num_levels: int = 4,
    min_win: int = 256,
    max_win: int = 4096,
    steps_per_level: int = 400,
    lr: float = 3e-2,
    beta: float = 100.0,
    seed: int = 0,
    init: FilterbankFit | None = None,
    reassign: bool = True,
    reassign_frac: float = 0.01,
    rescale_variance: bool = True,
    device=None,  # None = the card; "cpu" as asked
) -> FilterbankFit:
    """Coarse-to-fine Whittle fit of a D-component probabilistic filterbank.

    Equivalent of fit_probSTFT_SD(y, D, kernel, opts): anneal the Welch
    window from min_win to max_win over num_levels, re-optimizing at each
    level, from centers spread uniformly over (0, pi).  ``reassign`` moves
    dead or duplicate components (``_reassign_dead``) after each level; after
    the final level the moved components are re-fit and re-checked (up to 3
    rounds).  ``rescale_variance`` makes the component variances sum to the
    signal variance at exit (ref :484-490).  ``beta`` tops the annealed
    shrinkage schedule logspace(log10(beta), 0) on the component variances
    (ref :179-183).  ``seed`` is unused, as in JAX.
    """
    dev = resolve_device(device)
    y = torch.as_tensor(y).to(dev)
    dt_ = y.dtype
    var_y = y.var(correction=0)
    t = lambda x: torch.as_tensor(x, dtype=dt_, device=dev)

    if init is None:
        omega_init = (np.arange(D) + 0.5) / D * np.pi
        uo = np.log(omega_init / np.pi) - np.log1p(-omega_init / np.pi)  # logit of omega/pi
        log_params = torch.cat([
            torch.log(var_y / D).expand(D),
            torch.full((D,), math.log(2.0 * math.pi / max_win * 4.0), dtype=dt_, device=dev),
            t(uo),
            torch.log(var_y * 0.1)[None],
        ])
    else:
        w0 = torch.clamp(t(init.omega) / math.pi, 1e-4, 1 - 1e-4)
        log_params = torch.cat([torch.log(t(init.sigma2)), torch.log(t(init.lam)),
                                torch.log(w0) - torch.log1p(-w0), torch.log(t(init.noise))[None]])

    wins = np.unique(np.geomspace(min_win, max_win, num_levels).astype(int) // 2 * 2)

    def optimize(log_params, w, target, bet):
        (p,), val = adam(lambda pp: _whittle_obj(kernel, pp, w, target, bet), [log_params],
                         lr, steps_per_level)
        return p, val

    betas = (np.logspace(np.log10(beta), 0.0, len(wins)) if beta > 0.0
             else np.zeros(len(wins)))
    obj = torch.zeros((), dtype=dt_, device=dev)
    for lvl, nwin in enumerate(wins):
        w, target = welch(y, int(nwin))
        w, target = w[1:], target[1:]  # drop DC
        bet = float(betas[lvl])
        log_params, obj = optimize(log_params, w, target, bet)
        if reassign:
            # Final level: reassign -> re-fit until clean, then one last
            # reassignment WITHOUT re-optimization, so the returned fit is
            # duplicate-free even when the optimizer keeps re-collapsing.
            final = lvl == len(wins) - 1
            rounds = 3 if final else 1
            w_h, target_h = w.cpu().numpy(), target.cpu().numpy()
            for r in range(rounds):
                p, moved = _reassign_dead(kernel, log_params.cpu().numpy(), D, w_h, target_h,
                                          float(var_y), reassign_frac)
                if not moved:
                    break
                log_params = t(p)
                if final and r < rounds - 1:
                    log_params, obj = optimize(log_params, w, target, bet)

    sigma2, lam, omega0, noise = _unpack(log_params, D)
    if rescale_variance:
        sigma2 = sigma2 * (var_y / torch.sum(sigma2))
    order = torch.argsort(omega0)
    return FilterbankFit(sigma2=sigma2[order], lam=lam[order], omega=omega0[order],
                         noise=noise, obj=obj)


def fit_probstft_staged(y, D: int, kernel: str = "matern32", **kwargs) -> FilterbankFit:
    """Two-stage fit: 'exp' first, then refine with the target kernel, the
    LENGTHSCALE preserved (lam_new = LAM_SCALE[kernel] * lam_exp, since
    ell = scale / lam) (ref demo_nonstationary_filterbank.m:45-89)."""
    fit = fit_probstft(y, D, kernel="exp", **kwargs)
    if kernel in ("exp", "matern12"):
        return fit
    init = fit._replace(lam=fit.lam * LAM_SCALE[kernel])
    return fit_probstft(y, D, kernel=kernel, init=init, **kwargs)
