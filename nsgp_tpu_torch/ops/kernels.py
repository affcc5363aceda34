"""Covariance kernels -> LTI SDE (state-space) conversions.

Port of ``nsgp_tpu/ops/kernels.py`` (reference: matlab/unifying_prob_tf/
cf_exp_to_ss.m, cf_matern32_to_ss.m, cf_matern52_to_ss.m,
cf_matern72_to_ss.m, cf_se_to_ss.m).

Each kernel maps hyperparameters (magnitude sigma2, lengthscale ell) to a
small continuous-time model ``(F, L, Qc, H, Pinf)`` with

    dx/dt = F x + L w(t),   w ~ white noise with spectral density Qc,
    f(t)  = H x(t),         x(inf) ~ N(0, Pinf).

Inputs are 0-d tensors (or numbers); outputs take their dtype and device.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch


class StateSpace(NamedTuple):
    """Single-channel continuous-time state-space model."""

    F: torch.Tensor  # (tau, tau)
    L: torch.Tensor  # (tau, q)
    Qc: torch.Tensor  # (q, q)
    H: torch.Tensor  # (1, tau)
    Pinf: torch.Tensor  # (tau, tau)


def _scalars(sigma2, ell, dtype):
    sigma2 = torch.as_tensor(sigma2, dtype=dtype)
    ell = torch.as_tensor(ell, dtype=sigma2.dtype, device=sigma2.device)
    return sigma2, ell


@functools.lru_cache(maxsize=32)
def _companion_L_H(n: int, dtype, device):
    """A companion form's L = e_n (n, 1) and H = e_1 (1, n), made on the
    device (a host copy would sync) once per size, dtype and device and
    shared, so read-only."""
    eye = torch.eye(n, dtype=dtype, device=device)
    return eye[:, -1:].contiguous(), eye[:1].contiguous()


# ---------------------------------------------------------------------------
# Matern family (exact SDE forms)
# ---------------------------------------------------------------------------


def exp_to_ss(sigma2, ell, dtype=None) -> StateSpace:
    """Exponential (Matern-1/2, OU) kernel.  Ref: cf_exp_to_ss.m:92-146."""
    sigma2, ell = _scalars(sigma2, ell, dtype)
    F = (-1.0 / ell).reshape(1, 1)
    L = torch.ones((1, 1), dtype=sigma2.dtype, device=sigma2.device)
    Qc = (2.0 * sigma2 / ell).reshape(1, 1)
    H = torch.ones((1, 1), dtype=sigma2.dtype, device=sigma2.device)
    Pinf = sigma2.reshape(1, 1)
    return StateSpace(F, L, Qc, H, Pinf)


def matern32_to_ss(sigma2, ell, dtype=None) -> StateSpace:
    """Matern-3/2 kernel.  Ref: cf_matern32_to_ss.m:93-116."""
    sigma2, ell = _scalars(sigma2, ell, dtype)
    sqrt3 = math.sqrt(3.0)
    lam = sqrt3 / ell
    z = torch.zeros_like(sigma2)
    one = torch.ones_like(sigma2)
    F = torch.stack([torch.stack([z, one]), torch.stack([-(lam**2), -2.0 * lam])])
    L, H = _companion_L_H(2, sigma2.dtype, sigma2.device)
    Qc = (12.0 * sqrt3 / ell**3 * sigma2).reshape(1, 1)
    Pinf = torch.diag(torch.stack([sigma2, 3.0 * sigma2 / ell**2]))
    return StateSpace(F, L, Qc, H, Pinf)


def matern52_to_ss(sigma2, ell, dtype=None) -> StateSpace:
    """Matern-5/2 kernel.  Ref: cf_matern52_to_ss.m (companion form)."""
    sigma2, ell = _scalars(sigma2, ell, dtype)
    lam = math.sqrt(5.0) / ell
    z = torch.zeros_like(sigma2)
    one = torch.ones_like(sigma2)
    F = torch.stack(
        [
            torch.stack([z, one, z]),
            torch.stack([z, z, one]),
            torch.stack([-(lam**3), -3.0 * lam**2, -3.0 * lam]),
        ]
    )
    L, H = _companion_L_H(3, sigma2.dtype, sigma2.device)
    # Qc = sigma2 * 400 * sqrt(5) / 3 / ell^5
    Qc = (sigma2 * 400.0 * math.sqrt(5.0) / 3.0 / ell**5).reshape(1, 1)
    kappa = 5.0 / 3.0 * sigma2 / ell**2
    Pinf = torch.stack(
        [
            torch.stack([sigma2, z, -kappa]),
            torch.stack([z, kappa, z]),
            torch.stack([-kappa, z, 25.0 * sigma2 / ell**4]),
        ]
    )
    return StateSpace(F, L, Qc, H, Pinf)


def matern72_to_ss(sigma2, ell, dtype=None) -> StateSpace:
    """Matern-7/2 kernel.  Ref: cf_matern72_to_ss.m (companion form)."""
    sigma2, ell = _scalars(sigma2, ell, dtype)
    lam = math.sqrt(7.0) / ell
    z = torch.zeros_like(sigma2)
    one = torch.ones_like(sigma2)
    F = torch.stack(
        [
            torch.stack([z, one, z, z]),
            torch.stack([z, z, one, z]),
            torch.stack([z, z, z, one]),
            torch.stack([-(lam**4), -4.0 * lam**3, -6.0 * lam**2, -4.0 * lam]),
        ]
    )
    L, H = _companion_L_H(4, sigma2.dtype, sigma2.device)
    Qc = (sigma2 * 10976.0 * math.sqrt(7.0) / 5.0 / ell**7).reshape(1, 1)
    kappa = 7.0 / 5.0 * sigma2 / ell**2
    kappa2 = 9.8 * sigma2 / ell**4
    Pinf = torch.stack(
        [
            torch.stack([sigma2, z, -kappa, z]),
            torch.stack([z, kappa, z, -kappa2]),
            torch.stack([-kappa, z, kappa2, z]),
            torch.stack([z, -kappa2, z, 343.0 * sigma2 / ell**6]),
        ]
    )
    return StateSpace(F, L, Qc, H, Pinf)


# ---------------------------------------------------------------------------
# Squared-exponential (Taylor approximation, default order 6)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=8)
def _se_canonical_coeffs(order: int) -> np.ndarray:
    """Stable-root companion-form coefficients for the unit-lengthscale SE.

    Same numpy factorisation as the JAX package (ref cf_se_to_ss.m:104-134):
    returns ``a`` (order,), where for a general lengthscale the companion F
    has last row ``-a_k * ell**(k-order)`` in column k.
    """
    kappa = 0.5  # 1 / (2 ell^2) at ell = 1
    fn = math.factorial(order)
    p = np.zeros(2 * order + 1)
    for n in range(order + 1):
        p[2 * order - 2 * n] = fn * (4.0 * kappa) ** (order - n) / math.factorial(n) / (-1.0) ** n
    r = np.roots(p)
    r_stable = r[np.real(r) < 0]
    a_monic = np.real(np.poly(r_stable))  # descending: [1, a_{N-1}, ..., a_0]
    return a_monic[1:][::-1].copy()  # a[k] multiplies x^k, k=0..order-1


@functools.lru_cache(maxsize=16)
def _se_unit_coeffs(order: int, dtype, device) -> torch.Tensor:
    """``_se_canonical_coeffs`` on the device, made once per order, dtype and
    device and shared, so read-only."""
    return torch.as_tensor(_se_canonical_coeffs(order), dtype=dtype, device=device)


def se_to_ss(sigma2, ell, order: int = 6, dtype=None) -> StateSpace:
    """Squared-exponential kernel, order-``order`` Taylor approximation.

    Ref: cf_se_to_ss.m:104-144.  Lengthscale scaling of the cached unit
    factorisation is exact; Pinf solves the Lyapunov equation (``lyap``).
    """
    sigma2, ell = _scalars(sigma2, ell, dtype)
    dt_, dev = sigma2.dtype, sigma2.device
    a_unit = _se_unit_coeffs(order, dt_, dev)
    N = order
    fn = math.factorial(N)
    kappa = 1.0 / (2.0 * ell**2)
    Qc = (sigma2 * torch.sqrt(math.pi / kappa) * fn * (4.0 * kappa) ** N).reshape(1, 1)
    powers = torch.arange(N, dtype=dt_, device=dev) - N  # k - N for k = 0..N-1
    a = a_unit * ell**powers
    F = torch.diag(torch.ones((N - 1,), dtype=dt_, device=dev), 1)
    F = torch.cat([F[:-1], -a[None]], dim=0)
    L = torch.zeros((N, 1), dtype=dt_, device=dev)
    L[-1, 0] = 1.0
    H = torch.zeros((1, N), dtype=dt_, device=dev)
    H[0, 0] = 1.0
    Pinf = lyap(F, L @ Qc @ L.T)
    return StateSpace(F, L, Qc, H, Pinf)


def lyap(F: torch.Tensor, Q: torch.Tensor) -> torch.Tensor:
    """Solve F P + P F' + Q = 0 for P via the Kronecker-vectorized system.

    Fine for the tiny (tau <= 8) blocks used here.
    """
    n = F.shape[0]
    eye = torch.eye(n, dtype=F.dtype, device=F.device)
    M = torch.kron(eye, F) + torch.kron(F, eye)
    p = torch.linalg.solve(M, -Q.reshape(-1))
    P = p.reshape(n, n)
    return 0.5 * (P + P.T)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

KERNELS = {
    "exp": exp_to_ss,
    "matern12": exp_to_ss,
    "matern32": matern32_to_ss,
    "matern52": matern52_to_ss,
    "matern72": matern72_to_ss,
    "se": se_to_ss,
}

KERNEL_ORDER = {
    "exp": 1,
    "matern12": 1,
    "matern32": 2,
    "matern52": 3,
    "matern72": 4,
    "se": 6,
}


def get_kernel(name: str):
    try:
        return KERNELS[name]
    except KeyError:
        raise ValueError(f"unknown kernel {name!r}; available: {sorted(KERNELS)}")


def kernel_state_dim(name: str) -> int:
    return KERNEL_ORDER[name]
