"""Batched Riccati (DARE) and discrete-Lyapunov solvers.

Port of ``nsgp_tpu/ops/dare.py``.  The reference relies on MATLAB's
``dare()`` (ihgp_ep_modulator_nmf.m:112-191), a LAPACK Schur method that
neither batches nor runs on a card.  Here every (channel x grid point) DARE
is solved at once by the *structure-preserving doubling algorithm* (SDA):
quadratically convergent, a fixed iteration count, nothing but batched small
matmuls and solves.

Filtering DARE solved here (prediction covariance form):

    P = A P A' + Q - A P h (h' P h + r)^{-1} h' P A'

with scalar measurement row ``h`` and noise ``r``.  This is the dual of the
control DARE, so SDA runs on (A', h h'/r, Q):

    A_{k+1} = A_k (I + G_k H_k)^{-1} A_k
    G_{k+1} = G_k + A_k (I + G_k H_k)^{-1} G_k A_k'
    H_{k+1} = H_k + A_k' H_k (I + G_k H_k)^{-1} A_k,   H_k -> P.

The smoother steady covariance solves X = M X M' + Q by squaring-doubling.

Solves use ``torch.linalg.solve_ex`` and never read its ``info``: an exactly
singular system gives inf / NaN as JAX's solve does, with no device-to-host
check.  The iteration therefore cannot raise; failures are caught by
``dare_residual`` (``inference.ihgp.build_tables`` drops those grid points).
Every function is batched over any leading axes, which broadcast.
"""

from __future__ import annotations

import numpy as np
import torch


def _sym(M):
    return 0.5 * (M + M.transpose(-1, -2))


def _solve(A, B):
    """A^{-1} B without an error check (JAX semantics: inf / NaN if singular)."""
    return torch.linalg.solve_ex(A, B)[0]


def dare_filter(A, h, Q, r, iters: int = 30, ridge: float = 0.0):
    """Steady-state *prediction* covariance P of a scalar-output Kalman filter.

    A (..., bs, bs) transition, h (..., bs) measurement row, Q (..., bs, bs)
    process noise, r (...) measurement noise variance; the leading axes
    broadcast.  Returns (..., bs, bs) P solving the filtering DARE above.
    """
    r = torch.as_tensor(r, dtype=A.dtype, device=A.device)
    bs = A.shape[-1]
    eye = torch.eye(bs, dtype=A.dtype, device=A.device)
    Ak = A.transpose(-1, -2)  # dual: run SDA on A'
    Gk = h[..., :, None] * h[..., None, :] / r[..., None, None]
    Hk = Q + ridge * eye
    shape = torch.broadcast_shapes(Ak.shape, Gk.shape, Hk.shape)
    Ak, Gk, Hk = Ak.expand(shape), Gk.expand(shape), Hk.expand(shape)
    for _ in range(iters):
        W = eye + Gk @ Hk
        WinvA = _solve(W, Ak)
        A_next = Ak @ WinvA
        G_next = Gk + Ak @ _solve(W, Gk @ Ak.transpose(-1, -2))
        H_next = Hk + Ak.transpose(-1, -2) @ Hk @ WinvA
        Ak, Gk, Hk = A_next, _sym(G_next), _sym(H_next)
    return _sym(Hk)


def dare_residual(P, A, h, Q, r):
    """Relative fixed-point residual of the filtering DARE at ``P``, (...).

    Large or non-finite (reported as inf) => no valid stabilizing solution,
    e.g. an undetectable unstable channel (the reference's failed ``dare()``
    calls, ihgp_ep_modulator_nmf.m:114-128).
    """
    r = torch.as_tensor(r, dtype=P.dtype, device=P.device)
    Ph = (P @ h[..., None])[..., 0]
    S = (h * Ph).sum(-1) + r
    APh = (A @ Ph[..., None])[..., 0]
    P_next = A @ P @ A.transpose(-1, -2) + Q - APh[..., :, None] * APh[..., None, :] / S[..., None, None]
    num = torch.linalg.matrix_norm(P_next - P)
    den = 1.0 + torch.linalg.matrix_norm(P)
    res = num / den
    return torch.where(torch.isfinite(res), res, torch.full_like(res, float("inf")))


def dlyap_doubling(M, Q, iters: int = 30):
    """Solve X = M X M' + Q by squaring-doubling (rho(M) < 1 required)."""
    Mk, Xk = M, _sym(Q)
    for _ in range(iters):
        X_next = Xk + Mk @ Xk @ Mk.transpose(-1, -2)
        Mk, Xk = Mk @ Mk, _sym(X_next)
    return Xk


def cubic_interp_matrix(xg, xq):
    """Catmull-Rom cubic interpolation weights from grid ``xg`` (sorted,
    uniform in the coordinate the caller passes) to query points ``xq``: the
    reference's ``apxGrid('interp', {ro}, r, 3)`` (ihgp_ep_modulator_nmf.m:
    130-133).  Returns W (len(xq), len(xg)), rows summing to 1, as a numpy
    float64 array (a static precomputation)."""
    xg = np.asarray(xg, np.float64)
    xq = np.asarray(xq, np.float64)
    n = xg.shape[0]
    W = np.zeros((xq.shape[0], n))
    dx = xg[1] - xg[0]
    t_all = (xq - xg[0]) / dx
    i1 = np.clip(np.floor(t_all).astype(int), 0, n - 2)
    t = t_all - i1
    # Catmull-Rom basis on points i1-1, i1, i1+1, i1+2 (clamped at edges)
    w_m1 = 0.5 * (-t + 2 * t**2 - t**3)
    w_0 = 0.5 * (2 - 5 * t**2 + 3 * t**3)
    w_p1 = 0.5 * (t + 4 * t**2 - 3 * t**3)
    w_p2 = 0.5 * (-(t**2) + t**3)
    rows = np.arange(xq.shape[0])
    for off, w in ((-1, w_m1), (0, w_0), (1, w_p1), (2, w_p2)):
        idx = np.clip(i1 + off, 0, n - 1)
        np.add.at(W, (rows, idx), w)
    return W
