"""EP moment matching for the modulator likelihoods.

Port of ``nsgp_tpu/ops/moments.py`` (reference: matlab/likModulatorNMFPower.m,
likModulatorPower.m, experiments/likModulatorPreCalcwn.m).

The observation model couples D subband values z and N modulator values g
through a single scalar sample:

    amplitude variant ('amp'): y ~ N( a(g)' z,  sn2/alpha ),  a(g) = W link(g)
    spectrogram variant ('sq'): a(g) = sqrt(W link(g))

Given a Gaussian cavity q(z, g) = N(mu, diag(s2)) (dimensions split as
[D subbands | N modulators]), lZ = log E_q[ N(y | a(g)'z, sn2/alpha) ] has an
analytic z-integral and an N-dim g-integral handled by sigma points:

    Z = sum_s w_s N(y | a_s' mu_z,  sn2/alpha + a_s'^2 s2_z)

with a_s = a(x_s), x_s = mu_g + sqrt(s2_g) * xi_s.

This is the all-T EP re-site between sweeps.  It is plain torch on every
device, as the JAX package leaves it to XLA outside Pallas.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from nsgp_tpu_torch.ops import cubature

_LOG2PI = math.log(2.0 * math.pi)
_JITTER = 1e-10  # floor on Z, ref likModulatorNMFPower.m:28,55


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + exp(x)), exact for all x (``torch.nn.functional.softplus``
    switches to the identity above a threshold; jax's softplus does not)."""
    return torch.logaddexp(x, torch.zeros_like(x))


LINKS = {"softplus": softplus, "exp": torch.exp}


class MomentParams(NamedTuple):
    """Static configuration of a moment function."""

    D: int
    N: int
    p_cubature: int = 9
    link: str = "softplus"
    variant: str = "amp"  # 'amp' (likModulatorNMFPower) or 'sq' (PreCalcwn)
    method: str = "symmetric"  # 'symmetric' (utp) or 'gh' tensor grid
    z_floor: float = _JITTER  # raw-scale floor on Z
    use_pep_const: bool = False


def sigma_points(mp: MomentParams, dtype=torch.float64, device=None):
    """Unit sigma points: weights (S,), points (S, N).

    Built once per rule, dtype and device and then shared by every caller
    (the sequential engine asks once a step): read them, never write them."""
    return _unit_points(mp.p_cubature, mp.N, mp.method, dtype, torch.device(device or "cpu"))


@functools.lru_cache(maxsize=32)
def _unit_points(p: int, n: int, method: str, dtype, device):
    w, x = cubature.unit_sigma_points(p, n, method)
    return (torch.as_tensor(w, dtype=dtype, device=device),
            torch.as_tensor(x.T, dtype=dtype, device=device))


def moments(
    mp: MomentParams,
    sn2,
    y,  # (...,) observations
    mu,  # (..., D+N) cavity means
    s2,  # (..., D+N) cavity variances
    W,  # (D, N) NMF weights
    ep_fraction=1.0,
):
    """lZ, dlZ, d2lZ of the tilted-distribution normalizer, batched.

    Shapes: y (...,), mu/s2 (..., D+N) -> lZ (...,), dlZ/d2lZ (..., D+N).
    Faithful to likModulatorNMFPower.m:28-86 ('amp') and
    likModulatorPreCalcwn.m:44-79 ('sq').
    """
    D = mp.D
    dtype = mu.dtype
    wn, xi = sigma_points(mp, dtype, mu.device)  # (S,), (S, N)

    mu_z, mu_g = mu.split([D, mp.N], dim=-1)
    s2_z, s2_g = s2.split([D, mp.N], dim=-1)
    mu_g = mu_g[..., None, :]
    s2_g = s2_g[..., None, :]

    xn = mu_g + torch.sqrt(s2_g) * xi  # (..., S, N)
    a = LINKS[mp.link](xn) @ W.T  # (..., S, D)
    if mp.variant == "sq":
        a = torch.sqrt(a)
    a2 = a * a

    # x / 1.0 is x: the sequential engine's fraction 1 costs no op
    s2_eff = _matvec(a2, s2_z) + (sn2 if ep_fraction == 1.0 else sn2 / ep_fraction)
    resid = y[..., None] - _matvec(a, mu_z)
    # Max-shifted sums: weights may be negative (ut7/ut9), so no logsumexp;
    # every derivative below is a ratio in which the exp(lmax) scale cancels.
    # The shift carries no gradient, as in the JAX package: the two agree
    # only while it cancels, which it does not where Z0 is clamped below.
    log_norm = -0.5 * (resid * resid / s2_eff + torch.log(s2_eff) + _LOG2PI)
    lmax = torch.amax(log_norm, dim=-1, keepdim=True).detach()
    # all -inf (every sigma point underflowed): exp(-inf - -inf) would be NaN
    lmax = torch.nan_to_num(lmax, nan=0.0, posinf=0.0, neginf=0.0)
    wnorm = wn * torch.exp(log_norm - lmax)  # (..., S)

    # Raw-scale floor Z >= z_floor exactly as the reference (max on the raw
    # sum, likModulatorNMFPower.m:55); the floored Z also feeds Zinv.
    Z0 = torch.clamp_min(wnorm.sum(-1), torch.finfo(dtype).tiny)
    lZ_raw = lmax[..., 0] + torch.log(Z0)
    lZ = torch.clamp_min(lZ_raw, _log_floor(mp.z_floor, dtype))
    Zinv = (torch.exp(lZ_raw - lZ) / Z0)[..., None]
    if mp.use_pep_const:
        pep_const = (2.0 * math.pi * sn2) ** (0.5 * (1.0 - ep_fraction)) * ep_fraction ** (-0.5)
        lZ = lZ + torch.log(torch.as_tensor(pep_const, dtype=dtype, device=mu.device))

    # --- derivatives w.r.t. the cavity means, first and second ---------------
    # z: sum_s w_s norm_s rs_s a_s and sum_s w_s norm_s (rs_s^2 - 1/s2eff_s) a_s^2
    rs = resid / s2_eff  # (..., S)
    dlZ_z = Zinv * _vecmat(wnorm * rs, a)
    d2lZ_z = Zinv * _vecmat(wnorm * (rs * rs - torch.reciprocal(s2_eff)), a2) - dlZ_z * dlZ_z
    # g: one weighted sum over [dmu_g, dmu_g^2 - 1/s2_g]
    dmu_g = (xn - mu_g) / s2_g  # (..., S, N)
    g_terms = torch.cat([dmu_g, dmu_g * dmu_g - torch.reciprocal(s2_g)], dim=-1)
    g_sums = Zinv * _vecmat(wnorm, g_terms)
    dlZ_g, d2_g = g_sums.chunk(2, dim=-1)
    dlZ = torch.cat([dlZ_z, dlZ_g], dim=-1)
    d2lZ = torch.cat([d2lZ_z, d2_g - dlZ_g * dlZ_g], dim=-1)
    return lZ, dlZ, d2lZ


def _matvec(M, v):
    """(..., S, K) x (..., K) -> (..., S); one op for a single site (the
    sequential engine calls once a step)."""
    return M @ v if v.dim() == 1 else (M @ v[..., None])[..., 0]


def _vecmat(v, M):
    """sum over S: (..., S) x (..., S, K) -> (..., K)."""
    return v @ M if v.dim() == 1 else (v[..., None, :] @ M)[..., 0, :]


@functools.lru_cache(maxsize=8)
def _log_floor(z_floor: float, dtype) -> float:
    return float(torch.log(torch.tensor(z_floor, dtype=dtype)))


def moments_chunked(
    mp: MomentParams, sn2, y, mu, s2, W, ep_fraction=1.0, chunk: int = 4096
):
    """``moments`` over a long leading T axis, ``chunk`` sites at a time.

    Bounds the (T, S, D) intermediate to (chunk, S, D).  Sites are
    independent, so chunking changes no value.
    """
    outs = [
        moments(mp, sn2, y[i : i + chunk], mu[i : i + chunk], s2[i : i + chunk],
                W, ep_fraction)
        for i in range(0, y.shape[0], chunk)
    ]
    lZ, dlZ, d2lZ = zip(*outs)
    return torch.cat(lZ), torch.cat(dlZ), torch.cat(d2lZ)
