"""Prefix-sum Kalman elements and their associative combines.

Port of the element algebra of ``nsgp_tpu/ops/pscan.py`` (Särkkä &
García-Fernández 2020, "Temporal parallelization of Bayesian smoothers").
Once the EP sites are fixed a sweep is a linear-Gaussian filter and smoother
whose steps compose associatively; ``ops.bscan`` composes them in chunks,
and ``parallel_filter_with_sites`` / ``parallel_rts_smoother`` compose all T
steps at once with ``associative_scan``, the port's counterpart of
``jax.lax.associative_scan`` (log depth, (T, C, bs, bs) elements in memory:
small T).

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


# ---------------------------------------------------------------------------
# The one-level log-depth scan
# ---------------------------------------------------------------------------


def _interleave(a, b):
    """Rows a0, b0, a1, b1, ... (len(a) - len(b) is 0 or 1)."""
    out = a.new_empty((a.shape[0] + b.shape[0],) + a.shape[1:])
    out[0::2] = a
    out[1::2] = b
    return out


def _scan(combine, elems):
    """The odd/even recursion of ``jax.lax.associative_scan``, combine for
    combine: pairs are reduced, the half-length scan recursed on, and the
    even rows completed from it."""
    n = elems[0].shape[0]
    if n < 2:
        return elems
    odd = _scan(combine, combine(tuple(e[0:-1:2] for e in elems),
                                 tuple(e[1::2] for e in elems)))
    rest = tuple(e[2::2] for e in elems)
    if n % 2 == 0:
        head = tuple(o[:-1] for o in odd)
        even = combine(head, rest) if n > 2 else rest
    else:
        even = combine(odd, rest)
    return tuple(_interleave(torch.cat([e[:1], v], dim=0), o)
                 for e, v, o in zip(elems, even, odd))


def associative_scan(combine, elems, reverse: bool = False):
    """Inclusive scan over axis 0 of a tuple of tensors, in log depth.

    ``combine(a, b)`` takes and returns tuples batched over the leading axis,
    ``a`` the earlier prefix.  With ``reverse`` the sequence is flipped first,
    exactly as JAX does: the FIRST argument of ``combine`` is then the suffix
    over later times, the second the earlier element applied on top.
    """
    elems = tuple(elems)
    if reverse:
        elems = tuple(torch.flip(e, [0]) for e in elems)
    out = _scan(combine, elems)
    if reverse:
        out = tuple(torch.flip(e, [0]) for e in out)
    return out


def affine_combine(a, b):
    """Compose two affine maps x -> M x + c, ``a`` applied first:
    (M_b M_a, M_b c_a + c_b).  Under ``reverse`` (``a`` the later suffix) the
    same code composes a backward recursion, as JAX's two combines of
    ``pretrain/filterbank.py`` do."""
    Ma, ca = a
    Mb, cb = b
    return Mb @ Ma, _mv(Mb, ca) + cb


def parallel_filter_with_sites(ssm: BlockSSM, sites: Sites):
    """O(log T)-depth forward filter with fixed EP sites: filtered
    (ms (T, C, bs), Ps (T, C, bs, bs)), as ``kalman.filter_with_sites``."""
    _, b, C, _, _ = associative_scan(_filter_combine, _filter_elements(ssm, sites))
    return b, C


def parallel_rts_smoother(ssm: BlockSSM, ms, Ps, jitter: float = 0.0):
    """O(log T)-depth RTS smoother over filtered (ms (T, C, bs), Ps (T, C,
    bs, bs)), as ``kalman.rts_smoother``.  ``jitter`` adds a diagonal ridge
    to the pseudo-prediction before the gain solve (the reference retries
    failed Choleskys with random jitter; this is a fixed ridge)."""
    A, Q = ssm.A, ssm.Q
    At = A.transpose(-1, -2)
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    Pk = Ps[:-1]
    Pp = _sym(A @ Pk @ At + Q) + jitter * eye
    PA = Pk @ At
    # E = P A' Pp^{-1}; pad_eye keeps padded dims nonsingular (PA rows are 0)
    E = torch.linalg.solve((Pp + ssm.pad_eye).transpose(-1, -2),
                           PA.transpose(-1, -2)).transpose(-1, -2)
    g = ms[:-1] - _mv(E, _mv(A, ms[:-1]))
    L = _sym(Pk - E @ Pp @ E.transpose(-1, -2))
    E = torch.cat([E, torch.zeros_like(E[:1])], dim=0)
    g = torch.cat([g, ms[-1:]], dim=0)
    L = torch.cat([L, Ps[-1:]], dim=0)
    _, g_s, L_s = associative_scan(_smoother_combine, (E, g, L), reverse=True)
    return g_s, _sym(L_s)


def filter_smoother_with_sites(ssm: BlockSSM, sites: Sites, jitter: float = 0.0):
    """One full linear-Gaussian forward/backward pass, parallel in time:
    smoothed (ms (T, C, bs), Ps (T, C, bs, bs))."""
    ms, Ps = parallel_filter_with_sites(ssm, sites)
    return parallel_rts_smoother(ssm, ms, Ps, jitter=jitter)
