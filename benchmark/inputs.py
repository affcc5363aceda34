"""Seeded inputs: prior draws of a model's own signal, in numpy float64.

The construction of the port's chip smoke test (``_gp_paths``,
``prior_signal``), frozen here so that the yardstick does not move with
the program.  Every draw depends only on the seed it is given.
"""

from __future__ import annotations

import numpy as np

_MATERN = {"exp": (1.0, 1), "matern32": (3.0, 2), "matern52": (5.0, 3)}


def gp_paths(rng, kernel: str, var, ell, T: int, omega=0.0) -> np.ndarray:
    """Stationary GP paths (T, len(var)) by spectral synthesis: white noise
    shaped by the Matern spectral density of each lengthscale, centred at
    ``omega`` (the quasi-periodic subbands), scaled to the marginal
    variances.  Circular in T."""
    two_nu, power = _MATERN[kernel]
    lam = np.sqrt(two_nu) / np.asarray(ell, float)[:, None]
    w = (np.fft.rfftfreq(T) * 2 * np.pi)[None, :]
    om = np.broadcast_to(np.asarray(omega, dtype=float), lam.shape[:1])[:, None]
    dens = (lam**2 + (w - om) ** 2) ** -power + (lam**2 + (w + om) ** 2) ** -power
    spec = (rng.normal(size=dens.shape) + 1j * rng.normal(size=dens.shape)) * np.sqrt(dens)
    x = np.fft.irfft(spec, T, axis=1)
    x -= x.mean(1, keepdims=True) * (om == 0.0)
    return (x / x.std(1, keepdims=True) * np.sqrt(np.asarray(var, float))[:, None]).T


def prior_signal(rng, model: dict, w: dict, T: int) -> np.ndarray:
    """y = sum_d a_d z_d + noise, subbands and modulators from ``gp_paths``,
    a = W softplus(g) ('amp') or its square root ('sq'); (T,)."""
    z = gp_paths(rng, model["kernel1"], w["sub_var"], w["sub_len"], T, w["omega"])
    g = gp_paths(rng, model["kernel2"], w["mod_var"], w["mod_len"], T)
    a = np.logaddexp(g, 0.0) @ np.asarray(w["W"], float).T
    if model["variant"] == "sq":
        a = np.sqrt(a)
    return (a * z).sum(1) + np.sqrt(float(w["lik"])) * rng.normal(size=T)


def stream(seed: int, *keys: int) -> np.random.Generator:
    """An independent generator for one input of one run."""
    return np.random.default_rng([int(seed) % (1 << 63), *keys])
