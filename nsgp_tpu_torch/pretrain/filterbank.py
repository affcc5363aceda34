"""Steady-state Kalman filterbank transform (complex subband coefficients).

Port of ``nsgp_tpu/pretrain/filterbank.py`` (ref kernel_ss_probFB.m,
kernel_ss_kalmanFastFB.m, kernel_ss_kalmanSlowFB_rewrite.m,
getFBLDSOutput_tau.m).

The stationary filterbank is a linear-Gaussian SSM: D (kernel x cosine)
subband blocks observed through their SUM, y_t = sum_d H_d x_d + eps.  The
shared scalar observation couples the channels, so the steady-state
covariance is dense over the joint state m = 2*tau*D.

Fast path (the reference's IHGP filterbank): one joint DARE
(``ops.dare.dare_filter``) -> steady gain K and transition M = (I - K H) A
-> filtered means by an affine scan m_k = M m_{k-1} + K y_k
(``ops.pscan.associative_scan``, log depth) -> steady smoother gain G and a
reverse affine scan.  Each subband block carries its quadrature pair in state
dims (0, 1): Z_d = x_d[0] + i x_d[1].

Slow path (exact, for gap masks and time-varying noise): a sequential dense
Kalman/RTS with per-step noise, NaN -> pure prediction; the mask goes to the
host once a call.

Entry points place their work by ``utils.device.resolve_device``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from nsgp_tpu_torch.ops import dare as dare_mod
from nsgp_tpu_torch.ops import kernels as K
from nsgp_tpu_torch.ops.pscan import affine_combine, associative_scan
from nsgp_tpu_torch.ops.ssm import lti_disc_stationary, subband_block
from nsgp_tpu_torch.pretrain.spectral import LAM_SCALE, component_spectra
from nsgp_tpu_torch.utils.device import resolve_device
from nsgp_tpu_torch.utils.precision import full_fp32


class Filterbank(NamedTuple):
    """Dense joint stationary filterbank model."""

    A: torch.Tensor  # (m, m)
    Q: torch.Tensor  # (m, m)
    Pinf: torch.Tensor  # (m, m)
    H: torch.Tensor  # (m,) joint observation row (sum over subbands)
    noise: torch.Tensor  # () observation noise variance
    D: int
    block: int  # per-subband block size (2 * tau)


def _vec(x, dev, dtype=None):
    return torch.atleast_1d(torch.as_tensor(x)).to(dev, dtype)


def build_filterbank(sigma2, ell, omega, kernel: str = "exp", noise=1e-4, dt: float = 1.0,
                     device=None) -> Filterbank:
    """Assemble the dense joint subband model (ref get_disc_model.m) in
    sigma2's dtype.  The blocks are formed in float64 and cast, as
    ``ops.ssm.build_modulator_ssm`` does (Q = Pinf - A Pinf A' cancels)."""
    dev = resolve_device(device)
    sigma2 = _vec(sigma2, dev)
    dtype = sigma2.dtype
    s2, ell, omega = (_vec(x, dev, torch.float64) for x in (sigma2, ell, omega))
    D = s2.shape[0]
    blocks = [subband_block(s2[d], ell[d], omega[d], kernel) for d in range(D)]
    F, _, H, Pinf = (torch.stack(x) for x in zip(*blocks))
    A, Q = lti_disc_stationary(F, Pinf, dt)
    bd = lambda blocks: torch.block_diag(*blocks).to(dtype)
    return Filterbank(A=bd(A), Q=bd(Q), Pinf=bd(Pinf), H=H.reshape(-1).to(dtype),
                      noise=torch.as_tensor(noise, dtype=dtype, device=dev), D=D,
                      block=2 * K.kernel_state_dim(kernel))


class FBResult(NamedTuple):
    Z: torch.Tensor  # (T, D) complex subband coefficients
    ms: torch.Tensor  # (T, m) smoothed state means
    Pvar: torch.Tensor  # (D,) steady smoothed per-subband marginal variance
    lml: torch.Tensor  # () log marginal likelihood of the signal


def _to_complex(ms: torch.Tensor, D: int, blk: int) -> torch.Tensor:
    x = ms.reshape(ms.shape[0], D, blk)
    return torch.complex(x[..., 0], x[..., 1])


def _place(fb: Filterbank, y, device):
    """(fb, y) on the device asked for (``resolve_device``), in their
    promoted dtype (as JAX promotes)."""
    dev = resolve_device(device)
    y = torch.as_tensor(y)
    dtype = torch.promote_types(fb.A.dtype, y.dtype)
    moved = {k: getattr(fb, k).to(dev, dtype) for k in ("A", "Q", "Pinf", "H", "noise")}
    return fb._replace(**moved), y.to(dev, dtype)


def steady_filterbank(fb: Filterbank, y, device=None) -> FBResult:
    """IHGP filterbank transform (fast path, parallel in time), with full
    float32 products (``utils.precision.full_fp32``)."""
    full_fp32()
    fb, y = _place(fb, y, device)
    A, Q, H, r = fb.A, fb.Q, fb.H, fb.noise
    m = A.shape[0]
    T = y.shape[0]

    P = dare_mod.dare_filter(A, H, Q, r)  # steady predictive covariance
    PH = P @ H
    S = H @ PH + r
    Kg = PH / S  # steady gain
    M = (torch.eye(m, dtype=A.dtype, device=A.device) - torch.outer(Kg, H)) @ A
    lml_const = -0.5 * torch.log(2.0 * math.pi * S)

    # affine scan over filtered means: m_k = M m_{k-1} + K y_k
    _, mf = associative_scan(affine_combine, (M.expand(T, m, m), Kg[None, :] * y[:, None]))

    # innovations for the likelihood: v_k = y_k - H A m_{k-1}
    mprev = torch.cat([torch.zeros((1, m), dtype=mf.dtype, device=mf.device), mf[:-1]])
    v = y - mprev @ (A.T @ H)
    lml = torch.sum(lml_const - 0.5 * v * v / S)

    # steady smoother: Pf = P - K S K'; G = Pf A' P^{-1}
    Pf = P - S * torch.outer(Kg, Kg)
    G = dare_mod._solve(P.T, (Pf @ A.T).T).T
    cvec = mf - mf @ (A.T @ G.T)  # m_f - G A m_f per row
    Gp = torch.cat([G.expand(T - 1, m, m), torch.zeros((1, m, m), dtype=G.dtype,
                                                        device=G.device)])
    cp = torch.cat([cvec[:-1], mf[-1:]])
    _, sm = associative_scan(affine_combine, (Gp, cp), reverse=True)

    # steady smoothed covariance PS = G PS G' + (Pf - G P G')
    QQ = Pf - G @ P @ G.T
    PS = dare_mod.dlyap_doubling(G, 0.5 * (QQ + QQ.T))
    Pvar = torch.diagonal(PS)[0::fb.block]
    return FBResult(Z=_to_complex(sm, fb.D, fb.block), ms=sm, Pvar=Pvar, lml=lml)


def exact_filterbank(
    fb: Filterbank,
    y,
    mask: Optional[torch.Tensor] = None,
    noise_t: Optional[torch.Tensor] = None,
    device=None,
) -> FBResult:
    """Exact dense Kalman/RTS filterbank (slow path; missing data and
    per-step observation noise; ref kernel_ss_kalmanSlowFB_rewrite.m:55-137).

    ``noise_t``: optional (T,) per-step observation-noise variance; defaults
    to the constant ``fb.noise``.  Python loops over T (small T)."""
    fb, y = _place(fb, y, device)
    mask = ~torch.isnan(y) if mask is None else mask.to(y.device, torch.bool)
    y = torch.nan_to_num(y)
    A, Q, H = fb.A, fb.Q, fb.H
    m = A.shape[0]
    if noise_t is None:
        noise_t = fb.noise.expand(y.shape)
    else:
        noise_t = torch.as_tensor(noise_t).to(A.device, A.dtype).broadcast_to(y.shape)
    observed = mask.tolist()  # one host copy a call

    mx = torch.zeros((m,), dtype=A.dtype, device=A.device)
    P = fb.Pinf
    zero = torch.zeros((), dtype=A.dtype, device=A.device)
    ms, Ps, lml = [], [], []
    for k in range(y.shape[0]):
        if k > 0:
            mx, P = A @ mx, A @ P @ A.T + Q
        P = 0.5 * (P + P.T)
        lml_k = zero
        if observed[k]:
            PH = P @ H
            S = H @ PH + noise_t[k]
            Kg = PH / S
            v = y[k] - H @ mx
            lml_k = -0.5 * (torch.log(2 * math.pi * S) + v * v / S)
            mx, P = mx + Kg * v, P - torch.outer(Kg, PH)
        ms.append(mx)
        Ps.append(P)
        lml.append(lml_k)

    eye = torch.eye(m, dtype=A.dtype, device=A.device)
    sm, sP = [ms[-1]], [Ps[-1]]
    m_next, P_next = ms[-1], Ps[-1]
    for k in range(y.shape[0] - 2, -1, -1):
        Pp = A @ Ps[k] @ A.T + Q + 1e-12 * eye
        G = dare_mod._solve(Pp.T, (Ps[k] @ A.T).T).T
        mk = ms[k] + G @ (m_next - A @ ms[k])
        Pk = Ps[k] + G @ (P_next - Pp) @ G.T
        sm.append(mk)
        sP.append(Pk)
        m_next, P_next = mk, 0.5 * (Pk + Pk.T)
    sm = torch.stack(sm[::-1])
    sP = torch.stack(sP[::-1])
    idx = torch.arange(fb.D, device=A.device) * fb.block
    Pvar = sP[:, idx, idx].mean(0)
    return FBResult(Z=_to_complex(sm, fb.D, fb.block), ms=sm, Pvar=Pvar,
                    lml=torch.sum(torch.stack(lml)))


def fft_filterbank(sigma2, ell, omega, y, kernel: str = "exp", noise=1e-4,
                   pad: Optional[int] = None, device=None):
    """FFT-domain Wiener-filter filterbank (ref probFB_FFT.m).

    For a stationary model the posterior subband means are circulant Wiener
    filters: Z_d = F^{-1}[ S_d(w) / (sum_e S_e(w) + noise) F y ], with S_d the
    two-sided spectral-mixture component spectrum; the analytic coefficients
    keep the positive frequencies doubled.  Zero-padding by ~3 lengthscales
    suppresses the circular wrap.  Returns Z (T, D) complex."""
    dev = resolve_device(device)
    y = torch.as_tensor(y).to(dev)
    dtype = y.dtype
    sigma2, ell, omega = (_vec(x, dev, dtype) for x in (sigma2, ell, omega))
    lam = LAM_SCALE[kernel] / ell
    T = y.shape[0]
    if pad is None:
        pad = int(3.0 * float(ell.max()))
    Tp = T + pad

    w_full = 2.0 * math.pi * torch.fft.fftfreq(Tp, dtype=torch.float64, device=dev).to(dtype)
    S = component_spectra(kernel, sigma2, lam, omega, w_full)  # (Tp, D)
    S_tot = S.sum(-1, keepdim=True) + noise

    Yf = torch.fft.fft(y, n=Tp)
    analytic = torch.where(w_full > 0, 2.0, torch.where(w_full == 0, 1.0, 0.0)).to(dtype)
    Zf = (S / S_tot) * (Yf * analytic)[:, None]
    return torch.fft.ifft(Zf, dim=0)[:T]
