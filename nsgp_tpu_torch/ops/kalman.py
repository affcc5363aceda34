"""Sequential Kalman filtering / RTS smoothing on block channels.

Port of ``nsgp_tpu/ops/kalman.py`` (ref gf_ep_modulator_nmf.m:126-274).
All state is channel-stacked:

    m (C, bs),  P (C, bs, bs),  sites ttau/tnu (T, C)

and every step is batched over C.  The EP measurement update uses the
branch-free "z-form"

    z = ttau * HPH + 1
    K = (P H) * ttau / z
    m <- m - (P H) * (ttau * fmu - tnu) / z
    P <- P - K (P H)'

which is algebraically identical to both branches of the reference's update
(gf_ep_modulator_nmf.m:159-176).  Missing observations are handled by zero
sites (z = 1 makes the update a no-op).

The passes are Python loops over T: this engine is the reference for small
T on the CPU (and the base of the energy/autograd path).  Long signals on
the card go through the fused kernels (``ops.fused_kalman``).  Trajectories
cross the function boundary in the JAX package's C-major flat layout,
(T, C*bs) and (T, C*bs*bs).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from nsgp_tpu_torch.ops.ssm import BlockSSM


class Sites(NamedTuple):
    """EP site (natural) parameters per time step and channel."""

    ttau: torch.Tensor  # (T, C) site precisions (>= 0)
    tnu: torch.Tensor  # (T, C) site precision-adjusted means


def init_sites(T: int, C: int, dtype=torch.float32, device=None) -> Sites:
    z = torch.zeros((T, C), dtype=dtype, device=device)
    return Sites(z, z.clone())


# ---------------------------------------------------------------------------
# Primitive steps (batched over channels)
# ---------------------------------------------------------------------------


def _sym(P):
    return 0.5 * (P + P.transpose(-1, -2))


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def predict(ssm: BlockSSM, m, P):
    """One prediction step: m <- A m, P <- A P A' + Q (per channel)."""
    return _mv(ssm.A, m), ssm.A @ P @ ssm.A.transpose(-1, -2) + ssm.Q


def marginals(ssm: BlockSSM, m, P):
    """Per-channel observable marginals: fmu (C,), PH (C,bs), HPH (C,)."""
    fmu = (ssm.H * m).sum(-1)
    PH = _mv(P, ssm.H)
    return fmu, PH, (ssm.H * PH).sum(-1)


def site_update(ssm: BlockSSM, m, P, ttau_k, tnu_k):
    """Branch-free EP measurement update for all channels at one step."""
    return _update(m, P, *marginals(ssm, m, P), ttau_k, tnu_k)


def _update(m, P, fmu, PH, HPH, ttau_k, tnu_k):
    """``site_update`` given the marginals of (m, P)."""
    z = ttau_k * HPH + 1.0
    v = (ttau_k * fmu - tnu_k) / z
    m = m - PH * v[:, None]
    kPH = (ttau_k / z)[:, None] * PH
    P = P - kPH[:, None, :] * PH[:, :, None]
    return m, _sym(P)


def moment_match(lZk, dlZ, d2lZ, fmu, fs2, ttau, tnu, damp, frac=1.0):
    """Damped EP site update from tilted-moment derivatives.

    Ref gf_ep_modulator_nmf.m:147-151.  Returns clamped (ttau >= 0) sites.
    """
    denom = 1.0 + d2lZ * fs2
    ttau_new = (1.0 - damp * frac) * ttau + (-damp) * (d2lZ / denom)
    tnu_new = (1.0 - damp * frac) * tnu + damp * ((dlZ - fmu * d2lZ) / denom)
    return torch.clamp_min(ttau_new, 0.0), tnu_new


# ---------------------------------------------------------------------------
# Whole-sequence passes
# ---------------------------------------------------------------------------


class PackedTrajectory(NamedTuple):
    """Time-stacked filter trajectories, flattened on the trailing axis."""

    ms: torch.Tensor  # (T, C*bs) filtered means
    Ps: torch.Tensor  # (T, C*bs*bs) filtered covariances


def smoother_gains_chunked(ssm: BlockSSM, Ps_flat, jitter: float = 0.0,
                           chunk: int = 4096):
    """Smoother gains G_k = P_k A' (A P_k A' + Q)^{-1} for ALL steps.

    Batched solves over ``chunk`` steps at a time.  All-zero rows (padding)
    get an identity added so the solve stays defined.  Returns
    (Gs (T, C*bs*bs), Pps (T, C*bs*bs)) with Pp_k = A P_k A' + Q.
    """
    C, bs = ssm.H.shape
    A, Q = ssm.A, ssm.Q
    eye = torch.eye(bs, dtype=A.dtype, device=A.device)
    Gs, Pps = [], []
    for i in range(0, Ps_flat.shape[0], chunk):
        Pb = Ps_flat[i : i + chunk]
        P = Pb.reshape(-1, C, bs, bs)
        Pp = _sym(A @ P @ A.transpose(-1, -2) + Q) + jitter * eye
        PA = P @ A.transpose(-1, -2)
        zero_row = torch.all(Pb == 0.0, dim=-1).to(A.dtype)[:, None, None, None]
        M = Pp + ssm.pad_eye[None] + eye * zero_row
        Gt = torch.linalg.solve(M.transpose(-1, -2), PA.transpose(-1, -2))
        n = P.shape[0]
        Gs.append(Gt.transpose(-1, -2).reshape(n, -1))
        Pps.append(Pp.reshape(n, -1))
    return torch.cat(Gs), torch.cat(Pps)


def filter_with_sites(ssm: BlockSSM, sites: Sites, store: bool = True,
                      jitter: float = 0.0) -> PackedTrajectory:
    """Linear-Gaussian forward filter given fixed EP sites.

    Ref gf_ep_modulator_nmf.m:126-184 with the itt>1 branch inactive.  The
    first step uses (0, Pinf) without a prediction, like the reference.
    """
    C, bs = ssm.H.shape
    m = torch.zeros_like(ssm.H)
    P = ssm.Pinf
    eye = jitter * torch.eye(bs, dtype=ssm.A.dtype, device=ssm.A.device)
    ms, Ps = [], []
    for k in range(sites.ttau.shape[0]):
        if k > 0:
            m, P = predict(ssm, m, P)
        P = _sym(P) + eye
        m, P = site_update(ssm, m, P, sites.ttau[k], sites.tnu[k])
        if store:
            ms.append(m.reshape(-1))
            Ps.append(P.reshape(-1))
    if store:
        return PackedTrajectory(ms=torch.stack(ms), Ps=torch.stack(Ps))
    return PackedTrajectory(ms=m.reshape(1, -1), Ps=P.reshape(1, -1))


def rts_smoother(ssm: BlockSSM, traj: PackedTrajectory, jitter: float = 0.0):
    """RTS smoothing pass over a stored packed trajectory.

    Ref gf_ep_modulator_nmf.m:207-234.  Gains for all steps come from one
    chunked batched solve, so the backward loop is an affine recursion:

        m_k <- m_k + G_k (m_{k+1} - A m_k)
        P_k <- P_k + G_k (P_{k+1} - Pp_{k+1}) G_k'
    """
    C, bs = ssm.H.shape
    A = ssm.A
    T = traj.ms.shape[0]
    Gs, Pps = smoother_gains_chunked(ssm, traj.Ps[:-1], jitter)
    # rows by unbind: one autograd node a pass, not a (T, ...) zero fill a step
    ms_f = traj.ms.reshape(T, C, bs).unbind(0)
    Ps_f = traj.Ps.reshape(T, C, bs, bs).unbind(0)
    Gs = Gs.reshape(T - 1, C, bs, bs).unbind(0)
    Pps = Pps.reshape(T - 1, C, bs, bs).unbind(0)
    m, P = ms_f[-1], Ps_f[-1]
    ms, Ps = [traj.ms[-1]], [traj.Ps[-1]]
    for k in range(T - 2, -1, -1):
        ms_k, Ps_k, G, Pp1 = ms_f[k], Ps_f[k], Gs[k], Pps[k]
        m = ms_k + _mv(G, m - _mv(A, ms_k))
        P = _sym(Ps_k + G @ (P - Pp1) @ G.transpose(-1, -2))
        ms.append(m.reshape(-1))
        Ps.append(P.reshape(-1))
    return torch.stack(ms[::-1]), torch.stack(Ps[::-1])


def observable_marginals(ssm: BlockSSM, ms, Ps):
    """(T, C) mean and variance of H x from flattened state trajectories
    ms (T, C*bs), Ps (T, C*bs*bs), as two block-structured matmuls
    (T, C*bs) @ (C*bs, C) that never form a (T, C, bs, bs) intermediate."""
    C, bs = ssm.H.shape
    eyeC = torch.eye(C, dtype=ssm.H.dtype, device=ssm.H.device)
    Hm = (ssm.H[:, :, None] * eyeC[:, None, :]).reshape(C * bs, C)
    HH = ssm.H[:, :, None] * ssm.H[:, None, :]  # (C, bs, bs)
    HHm = (HH[:, :, :, None] * eyeC[:, None, None, :]).reshape(C * bs * bs, C)
    return ms @ Hm, Ps @ HHm


def adf_filter(
    ssm: BlockSSM,
    y: torch.Tensor,  # (T,)
    mask: torch.Tensor,  # (T,) bool, True = observed
    sites: Sites,
    mom_fn,  # (y_k, fmu (C,), fs2 (C,), frac) -> (lZ, dlZ (C,), d2lZ (C,))
    damp: float,
    match_mask: Optional[torch.Tensor] = None,  # (T,) bool: do moment matching
):
    """Forward filter WITH interleaved moment matching (ADF / first EP pass).

    Ref gf_ep_modulator_nmf.m:126-192.  ``match_mask`` selects steps where
    sites are re-matched from the filter marginal (itt==1: all observed
    steps; itt>1: only the last step, the reference's
    ``itt == 1 || k == numel(yall)`` branch).
    """
    T = y.shape[0]
    if match_mask is None:
        match_mask = torch.ones_like(mask)
    do_match = (mask & match_mask).tolist()
    obs = mask.tolist()
    m = torch.zeros_like(ssm.H)
    P = ssm.Pinf
    zero = torch.zeros((), dtype=m.dtype, device=m.device)
    # rows by unbind: one autograd node a pass, not a (T, C) zero fill a step
    ys, ttaus, tnus = y.unbind(0), sites.ttau.unbind(0), sites.tnu.unbind(0)
    ms, Ps, lZs, tts, tns = [], [], [], [], []
    for k in range(T):
        if k > 0:
            m, P = predict(ssm, m, P)
        fmu, PH, HPH = marginals(ssm, m, P)
        if do_match[k]:
            lZk, dlZ, d2lZ = mom_fn(ys[k], fmu, HPH, 1.0)
            tt, tn = moment_match(lZk, dlZ, d2lZ, fmu, HPH, ttaus[k], tnus[k], damp, 1.0)
        else:
            lZk, tt, tn = zero, torch.clamp_min(ttaus[k], 0.0), tnus[k]
        # Masked (unobserved) steps: zero sites => update is a no-op.
        if obs[k]:
            m, P = _update(m, P, fmu, PH, HPH, tt, tn)
        else:
            m, P = _update(m, P, fmu, PH, HPH, torch.zeros_like(tt), torch.zeros_like(tn))
        ms.append(m.reshape(-1))
        Ps.append(P.reshape(-1))
        lZs.append(lZk)
        tts.append(tt)
        tns.append(tn)
    traj = PackedTrajectory(ms=torch.stack(ms), Ps=torch.stack(Ps))
    return traj, torch.stack(lZs), Sites(torch.stack(tts), torch.stack(tns))
