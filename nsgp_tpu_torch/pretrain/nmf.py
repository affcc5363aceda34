"""Nonnegative matrix factorization with the Itakura-Saito-like cost.

Port of ``nsgp_tpu/pretrain/nmf.py`` (ref matlab/experiments/nmf/nmf_fp.m,
nmf_inf_fp.m, tnmf.m): initialises the NMF weights W and modulator envelopes
from GPPAD amplitudes (train_model.m:116-129).

Cost (ref nmf.m:10-11):  C(A, Ahat) = sum [ A / Ahat + log Ahat ],
Ahat = H W' (T x D) with H (T, N) temporal components, W (D, N) weights.

Multiplicative updates (gradient-split form):

    H <- H * [ (A / Ahat^2) W ] / [ (1 / Ahat) W ]
    W <- W * [ (A / Ahat^2)' H ] / [ (1 / Ahat)' H ]

The restarts run batched on a leading axis.  JAX draws its random starts
from a PRNG key that torch cannot reproduce; here they come from a
``torch.Generator``, or are given as ``init`` (the unit draws, which the
functions scale as JAX scales its own).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from nsgp_tpu_torch.pretrain.adam import adam
from nsgp_tpu_torch.utils.device import resolve_device

_EPS = 1e-12


class NMFResult(NamedTuple):
    W: torch.Tensor  # (D, N)
    H: torch.Tensor  # (T, N)
    cost: torch.Tensor  # ()


def _tr(M):
    return M.transpose(-1, -2)


def _cost(A, H, W):
    Ahat = H @ _tr(W) + _EPS
    return torch.sum(A / Ahat + torch.log(Ahat), (-2, -1))


def _update_H(A, H, W):
    Ahat = H @ _tr(W) + _EPS
    R2 = A / (Ahat * Ahat)
    R1 = 1.0 / Ahat
    return H * (R2 @ W) / (R1 @ W + _EPS)


def _updates(A, H, W):
    H = _update_H(A, H, W)
    Ahat = H @ _tr(W) + _EPS
    R2 = A / (Ahat * Ahat)
    R1 = 1.0 / Ahat
    W = W * (_tr(R2) @ H) / (_tr(R1) @ H + _EPS)
    return H, W


def _generator(generator, dev):
    return generator if generator is not None else torch.Generator(dev).manual_seed(0)


def nmf_fp(
    A,  # (T, D) nonnegative data (squared envelopes)
    N: int,
    iters: int = 300,
    restarts: int = 20,
    generator: Optional[torch.Generator] = None,
    init=None,
    device=None,
) -> NMFResult:
    """Fixed-point NMF with batched random restarts (ref nmf_fp.m:34-58).

    The starts are scale * U with U uniform on [0.5, 1.5): ``init`` = (U_H
    (restarts, T, N), U_W (restarts, D, N)), else drawn from ``generator``
    (default seed 0) on its own device.  The restart of least cost wins."""
    dev = resolve_device(device)
    A = torch.as_tensor(A).to(dev)
    T, D = A.shape
    scale = torch.sqrt(A.mean() / N)
    if init is None:
        gen = _generator(generator, dev)
        init = tuple(torch.rand(shape, generator=gen, dtype=A.dtype, device=gen.device) + 0.5
                     for shape in ((restarts, T, N), (restarts, D, N)))
    H, W = (scale * torch.as_tensor(u).to(dev, A.dtype) for u in init)
    for _ in range(iters):
        H, W = _updates(A, H, W)
    costs = _cost(A, H, W)
    best = torch.argmin(costs)
    return NMFResult(W=W[best], H=H[best], cost=costs[best])


def nmf_inf(A, W, iters: int = 300, device=None) -> torch.Tensor:
    """H-only inference at fixed W (ref nmf_inf_fp.m).  Returns H (T, N)."""
    dev = resolve_device(device)
    A, W = torch.as_tensor(A).to(dev), torch.as_tensor(W).to(dev)
    N = W.shape[1]
    H = torch.sqrt(A.mean() / N).expand(A.shape[0], N)
    for _ in range(iters):
        H = _update_H(A, H, W)
    return H


def order_by_fastness(H: torch.Tensor, W: torch.Tensor):
    """Order components by mean squared derivative, fastest first
    (ref train_model.m:126-129)."""
    speed = torch.mean(torch.diff(H, dim=0) ** 2, 0) / (torch.mean(H**2, 0) + _EPS)
    order = torch.argsort(-speed)
    return H[:, order], W[:, order]


# ---------------------------------------------------------------------------
# Temporal NMF (tNMF): log-GP smoothness priors on the components
# ---------------------------------------------------------------------------


class TNMFResult(NamedTuple):
    W: torch.Tensor  # (D, N)
    H: torch.Tensor  # (T, N) positive, temporally smooth components
    cost: torch.Tensor  # () final MAP objective


def _se_quad_penalty(T: int, ell, var, dtype, device):
    """rfft weights of the circulant SE prior on log H, one row a component:
    ell (N,) -> (N, T//2+1).  0.5 * sum_k |rfft(logH)_k|^2 * mult_k / (T S_k)
    is the exact log-GP negative log-prior (the reference's tnmf.m temporal
    prior, FFT-diagonalized)."""
    freqs = torch.arange(T // 2 + 1, dtype=dtype, device=device) * (2.0 * math.pi / T)
    S = var * math.sqrt(2.0 * math.pi) * ell[:, None] * torch.exp(
        -0.5 * (ell[:, None] * freqs) ** 2)
    S = torch.clamp_min(S, 1e-10)
    mult = torch.full((T // 2 + 1,), 2.0, dtype=dtype, device=device)
    mult[0] = 1.0
    if T % 2 == 0:
        mult[-1] = 1.0
    return mult / (T * S)


def _tnmf_objective(A, lH, W, pen):
    H = torch.exp(lH)
    Ahat = H @ W.T + _EPS
    is_cost = torch.sum(A / Ahat + torch.log(Ahat))
    # log-GP prior on each component's log-trajectory about its own mean
    # level, so the prior shapes smoothness, not scale
    F = torch.fft.rfft(lH - lH.mean(0, keepdim=True), dim=0)  # (F, N)
    return is_cost + 0.5 * torch.sum(torch.abs(F) ** 2 * pen.T)


def tnmf(
    A,  # (T, D) nonnegative data
    N: int,
    ell=200.0,  # temporal lengthscale(s) of the log-GP prior, samples
    iters: int = 500,
    var: float = 4.0,
    lr: float = 5e-2,
    generator: Optional[torch.Generator] = None,
    init=None,
    device=None,
) -> TNMFResult:
    """Temporal NMF: IS cost + SE log-GP smoothness priors on the components
    (ref tnmf.m, getObj_nmf_temp.m), Adam jointly in (log H, log W).

    The start is log(scale) + 0.1 * E with E standard normal: ``init`` =
    (E_H (T, N), E_W (D, N)), else drawn from ``generator`` (default seed 0)."""
    dev = resolve_device(device)
    A = torch.as_tensor(A).to(dev)
    T, D = A.shape
    dtype = A.dtype
    ell = torch.as_tensor(ell, dtype=dtype, device=dev).broadcast_to((N,))
    pen = _se_quad_penalty(T, ell, var, dtype, dev)
    log_scale = torch.log(torch.sqrt(A.mean() / N))
    if init is None:
        gen = _generator(generator, dev)
        init = tuple(torch.randn(shape, generator=gen, dtype=dtype, device=gen.device)
                     for shape in ((T, N), (D, N)))
    lH0, lW0 = (log_scale + 0.1 * torch.as_tensor(e).to(dev, dtype) for e in init)
    (lH, lW), cost = adam(lambda lH, lW: _tnmf_objective(A, lH, torch.exp(lW), pen),
                          [lH0, lW0], lr, iters)
    return TNMFResult(W=torch.exp(lW), H=torch.exp(lH), cost=cost)


def tnmf_inf(A, W, ell=200.0, iters: int = 400, var: float = 4.0, lr: float = 5e-2,
             device=None) -> torch.Tensor:
    """H-only temporal-NMF inference at fixed W (ref tnmf_inf.m)."""
    dev = resolve_device(device)
    A, W = torch.as_tensor(A).to(dev), torch.as_tensor(W).to(dev)
    T, N = A.shape[0], W.shape[1]
    dtype = A.dtype
    ell = torch.as_tensor(ell, dtype=dtype, device=dev).broadcast_to((N,))
    pen = _se_quad_penalty(T, ell, var, dtype, dev)
    lH0 = torch.log(torch.sqrt(A.mean() / N)).expand(T, N)
    (lH,), _ = adam(lambda lH: _tnmf_objective(A, lH, W, pen), [lH0], lr, iters)
    return torch.exp(lH)
