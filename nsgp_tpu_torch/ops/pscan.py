"""Prefix-sum Kalman elements and their associative combines.

Port of the element algebra of ``nsgp_tpu/ops/pscan.py`` (Särkkä &
García-Fernández 2020, "Temporal parallelization of Bayesian smoothers").
Once the EP sites are fixed a sweep is a linear-Gaussian filter and smoother
whose steps compose associatively; ``ops.bscan`` composes them in chunks.
The one-level log-depth scans of the JAX module
(``parallel_filter_with_sites``, ``parallel_rts_smoother``) are not ported.

Everything is batched over leading axes and the channel axis C: element
tensors are (..., C, bs, bs) / (..., C, bs).  The sites enter in natural
form (ttau, tnu), and every construction is branch-free in ttau: a zero site
reduces exactly to prediction.

Filtering element of step k >= 1 (transition A, noise Q, site ttau/tnu):

    z   = ttau * (H Q H') + 1
    K   = (Q H') * ttau / z
    A_k = (I - K H) A          b_k = (Q H') tnu / z
    C_k = (I - K H) Q          eta_k = A' H' tnu / z     J_k = A' H' ttau H A / z

Step 0 uses P0 = Pinf with no prediction: A_0 = 0, b_0 = Pinf H' tnu0 / z0,
C_0 = (I - K0 H) Pinf.  Combine (i earlier, j later):

    D   = (I + C_i J_j)^{-1}
    A   = A_j D A_i
    b   = A_j D (b_i + C_i eta_j) + b_j
    C   = A_j D C_i A_j' + C_j
    eta = A_i' D' (eta_j - J_j b_i) + eta_i
    J   = A_i' D' J_j A_i + J_i

After an inclusive scan the k-th element's (b, C) is the filtered (m_k, P_k).

Smoothing element of step k < T-1 (from the filtered m_k, P_k):

    Pp  = A P_k A' + Q
    E_k = P_k A' Pp^{-1}       g_k = m_k - E_k A m_k       L_k = P_k - E_k Pp E_k'

and (E, g, L)_{T-1} = (0, m_{T-1}, P_{T-1}); the reverse scan with

    (E_i, g_i, L_i) x (E_j, g_j, L_j) = (E_i E_j, E_i g_j + g_i, E_i L_j E_i' + L_i)

yields the smoothed (m^s_k, P^s_k) = (g, L).
"""

from __future__ import annotations

import torch

from nsgp_tpu_torch.ops.kalman import Sites
from nsgp_tpu_torch.ops.ssm import BlockSSM


def _sym(M):
    return 0.5 * (M + M.transpose(-1, -2))


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def _site_constants(ssm: BlockSSM):
    """QH, HQH and AH = A' H' (as a row it is H A) per channel."""
    QH = _mv(ssm.Q, ssm.H)
    return QH, (ssm.H * QH).sum(-1), _mv(ssm.A.transpose(-1, -2), ssm.H)


def _step_elements(ssm: BlockSSM, tt, tn):
    """Elements of steps that predict first; tt, tn (..., C)."""
    A, Q = ssm.A, ssm.Q
    QH, HQH, AH = _site_constants(ssm)
    z = tt * HQH + 1.0
    Kg = QH * (tt / z)[..., None]
    A_el = A - Kg[..., :, None] * AH[..., None, :]
    b_el = QH * (tn / z)[..., None]
    C_el = Q - Kg[..., :, None] * QH[..., None, :]
    eta_el = AH * (tn / z)[..., None]
    J_el = (tt / z)[..., None, None] * AH[..., :, None] * AH[..., None, :]
    return A_el, b_el, C_el, eta_el, J_el


def _first_element(ssm: BlockSSM, tt, tn):
    """(b0, C0) of the global step 0: P0 = Pinf, no prediction."""
    PH0 = _mv(ssm.Pinf, ssm.H)
    HPH0 = (ssm.H * PH0).sum(-1)
    z0 = tt * HPH0 + 1.0
    K0 = PH0 * (tt / z0)[..., None]
    b0 = PH0 * (tn / z0)[..., None]
    C0 = ssm.Pinf - K0[..., :, None] * PH0[..., None, :]
    return b0, C0


def _filter_elements(ssm: BlockSSM, sites: Sites):
    """The (T, C, ...) filtering elements of all steps."""
    A_el, b_el, C_el, eta_el, J_el = _step_elements(ssm, sites.ttau[1:], sites.tnu[1:])
    b0, C0 = _first_element(ssm, sites.ttau[0], sites.tnu[0])
    cat = lambda x0, xs: torch.cat([x0[None], xs], dim=0)
    zM, zv = torch.zeros_like(ssm.A), torch.zeros_like(b0)
    return (cat(zM, A_el), cat(b0, b_el), _sym(cat(C0, C_el)), cat(zv, eta_el),
            _sym(cat(zM, J_el)))


def _make_filter_elem(ssm: BlockSSM, tt, tn, is_first):
    """Filtering element for a batch of steps: tt, tn (nc, C) site rows,
    ``is_first`` (nc, 1, 1, 1) bool selecting the global step 0."""
    A_el, b_el, C_el, eta_el, J_el = _step_elements(ssm, tt, tn)
    b0, C0 = _first_element(ssm, tt, tn)
    m1, m2 = is_first, is_first[..., 0]
    zero = torch.zeros((), dtype=A_el.dtype, device=A_el.device)
    return (
        torch.where(m1, zero, A_el),
        torch.where(m2, b0, b_el),
        _sym(torch.where(m1, C0, C_el)),
        torch.where(m2, zero, eta_el),
        _sym(torch.where(m1, zero, J_el)),
    )


def _filter_combine(ei, ej):
    """Associative combine of filtering elements (i earlier, j later)."""
    Ai, bi, Ci, etai, Ji = ei
    Aj, bj, Cj, etaj, Jj = ej
    bs = Ai.shape[-1]
    eye = torch.eye(bs, dtype=Ai.dtype, device=Ai.device)
    M = eye + Ci @ Jj
    Mt = M.transpose(-1, -2)
    # X = Aj M^{-1}  via  M' X' = Aj'
    AjD = torch.linalg.solve(Mt, Aj.transpose(-1, -2)).transpose(-1, -2)
    A = AjD @ Ai
    b = _mv(AjD, bi + _mv(Ci, etaj)) + bj
    C = _sym(AjD @ Ci @ Aj.transpose(-1, -2) + Cj)
    At_i = Ai.transpose(-1, -2)
    Dt_resid = torch.linalg.solve(Mt, (etaj - _mv(Jj, bi))[..., None])[..., 0]
    eta = _mv(At_i, Dt_resid) + etai
    J = _sym(At_i @ torch.linalg.solve(Mt, Jj @ Ai) + Ji)
    return A, b, C, eta, J


def _smoother_combine(later, earlier):
    """Combine for the reverse scan: ``later`` is the suffix composed over
    later times, ``earlier`` the element applied on top of it."""
    Ea, ga, La = later
    Eb, gb, Lb = earlier
    return Eb @ Ea, _mv(Eb, ga) + gb, _sym(Eb @ La @ Eb.transpose(-1, -2) + Lb)
