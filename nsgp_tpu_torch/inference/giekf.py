"""Global iterated EKF inference for the GT-NMF model.

Port of ``nsgp_tpu/inference/giekf.py`` (ref gf_giekf_modulator_nmf.m /
ekf_update1.m / iekf_update1.m).

Unlike the EP engines, the EKF linearizes the single *scalar* observation
h(x) = (H_z x)' W link(H_g x), which couples every channel, so the posterior
covariance is dense: the joint model is materialized block-diagonally with
inert padded dims (state dim m = C * bs) and the recursions run on dense
(m x m) matrices, a Python loop over T.

Reference semantics replicated:
- ``l_iter`` inner IEKF re-linearizations per measurement update
  (iekf_update1.m:110-117),
- ``g_iter`` global passes: pass s >= 2 re-linearizes around the smoothed
  trajectory of pass s-1, warm-started from its smoothed (m, P) at k = 1,
- energy = sum of innovation negative log-likelihoods, differentiable by
  autograd (the reference hand-rolls a sensitivity recursion,
  gf_giekf_modulator_nmf.m:294-439).

Placement follows ``utils.device``: the card unless ``device="cpu"``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from nsgp_tpu_torch.models.gtnmf import GTNMFModel, GTNMFParams
from nsgp_tpu_torch.ops.moments import LINKS
from nsgp_tpu_torch.ops.ssm import BlockSSM
from nsgp_tpu_torch.utils.device import place_inputs
from nsgp_tpu_torch.utils.precision import full_fp32

# d link / dg in closed form (the JAX package takes it with jax.grad; an inner
# autograd call would need create_graph=True to keep the energy differentiable)
_LINK_DERIVATIVES = {"softplus": torch.sigmoid, "exp": torch.exp}


class GIEKFConfig(NamedTuple):
    g_iter: int = 3  # global (filter+smoother) passes
    l_iter: int = 5  # inner IEKF iterations per update (iekf_update1 default)
    jitter: float = 1e-9
    accept_tol: float = 1e-3  # a global pass is kept only if its innovation
    # NLL does not exceed the best accepted pass's by more than
    # accept_tol * |best|, so extra passes cannot degrade the posterior (the
    # reference has no such gate).  < 0 disables it: every finite pass is kept.


class GIEKFResult(NamedTuple):
    Eft: torch.Tensor  # (T, C) smoothed observable means
    Varft: torch.Tensor  # (T, C) smoothed observable variances
    ms: torch.Tensor  # (T, m) smoothed dense state means
    Ps: torch.Tensor  # (T, m, m) smoothed dense covariances
    nll: torch.Tensor  # () innovation NLL of the kept filter pass


def dense_model(ssm: BlockSSM):
    """Dense joint (A, Q, Pinf, Hd) with inert padded dims; Hd is (C, m), one
    observable row per channel.

    Identity noise on the zero-padded dims keeps every pseudo-prediction
    covariance nonsingular (A = 0 there, so P stays exactly the identity on
    the padded diagonal); H is zero on those dims, so they never couple to
    the measurement.  Without it the dense RTS solve is singular."""
    C, bs = ssm.A.shape[0], ssm.A.shape[-1]
    bd = lambda blocks: torch.block_diag(*blocks.unbind(0))
    pad = bd(ssm.pad_eye)
    eyeC = torch.eye(C, dtype=ssm.H.dtype, device=ssm.H.device)
    Hd = (eyeC[:, :, None] * ssm.H[None]).reshape(C, C * bs)
    return bd(ssm.A), bd(ssm.Q) + pad, bd(ssm.Pinf) + pad, Hd


def _measurement(model: GTNMFModel, W: torch.Tensor, f: torch.Tensor):
    """Scalar measurement and its gradient w.r.t. the observables f (C,).

    h = z' a(g);  'amp': a = W link(g);  'sq': a = sqrt(W link(g))
    (ref funh/funhd, gf_giekf_modulator_nmf.m:444-473, link at :97-99)."""
    D = model.D
    z, g = f[:D], f[D:]
    Wl = W @ LINKS[model.link](g)  # (D,)
    da_dg = W * _LINK_DERIVATIVES[model.link](g)[None, :]  # (D, N)
    if model.variant == "sq":
        a = torch.sqrt(torch.clamp_min(Wl, 1e-12))
        da_dg = da_dg / (2.0 * a[:, None])
    else:
        a = Wl
    return z @ a, torch.cat([a, z @ da_dg])


def _filter(model, W, sn2, A, Q, Hd, y, mask, m0, P0, l_iter: int):
    """One (I)EKF forward pass from (m0, P0).  Returns (ms (T, m),
    Ps (T, m, m), nll (), rejected steps ()).

    Reference-exact update (iekf_update1.m:110-117), the *pseudo-iterated*
    form: the innovation is re-evaluated at the moving M, the gain always
    uses the predicted P, there is no Jacobian correction term, and the
    covariance update uses the last iteration's K and S.  The energy
    contribution is the plain-EKF innovation NLL at the predicted mean
    (gf_giekf_modulator_nmf.m:424).

    Divergence guard: an observed update with S <= 0 or a non-finite state
    is rejected (the step becomes a pure prediction) and counted, which keeps
    prediction finite on hard float32 signals; the energy turns NaN on it.
    Unobserved steps are pure predictions."""
    eye = torch.eye(A.shape[0], dtype=A.dtype, device=A.device)
    mx, P = m0, P0
    ms, Ps, nlls, rejected = [], [], [], []
    for k, obs in enumerate(mask.tolist()):
        if k > 0:
            mx, P = A @ mx, A @ P @ A.T + Q
        P = 0.5 * (P + P.T)
        if obs:
            y_k = y[k]
            # plain-EKF quantities at the predicted mean (first linearization):
            # they feed the energy and iteration 1 of the loop
            yhat, dh = _measurement(model, W, Hd @ mx)
            J = dh @ Hd
            PJ = P @ J
            S0 = S = J @ PJ + sn2
            nll_k = 0.5 * (torch.log(2.0 * math.pi * S0) + (y_k - yhat) ** 2 / S0)
            M, K = mx, PJ / S
            for i in range(l_iter):
                if i > 0:  # iteration 1 linearizes at the predicted mean, as above
                    yhat, dh = _measurement(model, W, Hd @ M)
                    J = dh @ Hd
                    PJ = P @ J
                    S = J @ PJ + sn2
                    K = PJ / S
                M = M + K * (y_k - yhat)
            # Joseph form: equal to the reference's P - K S K' at the optimal
            # gain, but PSD-preserving in float32 over many global passes
            ImKJ = eye - torch.outer(K, J)
            P_upd = ImKJ @ P @ ImKJ.T + sn2 * torch.outer(K, K)
            P_upd = 0.5 * (P_upd + P_upd.T)
            ok = (S0 > 0.0) & (S > 0.0) & torch.isfinite(M).all() & torch.isfinite(P_upd).all()
            mx = torch.where(ok, M, mx)
            P = torch.where(ok, P_upd, P)
            nlls.append(torch.where(ok, nll_k, torch.zeros_like(nll_k)))
            rejected.append(~ok)
        ms.append(mx)
        Ps.append(P)
    zero = torch.zeros((), dtype=A.dtype, device=A.device)
    nll = torch.sum(torch.stack(nlls)) if nlls else zero
    n_rej = torch.stack(rejected).sum() if rejected else zero
    return torch.stack(ms), torch.stack(Ps), nll, n_rej


def _rts_dense(A, Q, ms, Ps, jitter: float):
    """Dense RTS smoother.  The gains of all steps come from one batched
    solve, so the backward loop is an affine recursion."""
    eye = torch.eye(A.shape[0], dtype=A.dtype, device=A.device)
    Pp = A @ Ps[:-1] @ A.T + Q + jitter * eye  # (T-1, m, m)
    G = torch.linalg.solve(Pp.transpose(-1, -2), (Ps[:-1] @ A.T).transpose(-1, -2))
    G = G.transpose(-1, -2)
    m, P = ms[-1], Ps[-1]
    out_m, out_P = [m], [P]
    for k in range(ms.shape[0] - 2, -1, -1):
        m = ms[k] + G[k] @ (m - A @ ms[k])
        P = Ps[k] + G[k] @ (P - Pp[k]) @ G[k].T
        P = 0.5 * (P + P.T)
        out_m.append(m)
        out_P.append(P)
    return torch.stack(out_m[::-1]), torch.stack(out_P[::-1])


def _giekf_pass(model, params, y, mask, A, Q, Hd, m0, P0, config: GIEKFConfig):
    """One global pass: (I)EKF filter + dense RTS smoother, and whether it
    stayed finite."""
    msf, Psf, nll, _ = _filter(model, params.W, params.lik, A, Q, Hd, y, mask, m0, P0,
                               config.l_iter)
    ms, Ps = _rts_dense(A, Q, msf, Psf, config.jitter)
    good = torch.isfinite(ms).all() & torch.isfinite(Ps).all() & torch.isfinite(nll)
    return ms, Ps, nll, good


def giekf_infer(
    model: GTNMFModel,
    params: GTNMFParams,
    y: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    config: GIEKFConfig = GIEKFConfig(),
    device=None,  # None = the card; "cpu" runs on the CPU
) -> GIEKFResult:
    """Global-IEKF posterior inference (prediction mode of the reference).

    The state starts from the prior on the first pass only; pass s >= 2
    warm-starts from the smoothed (m, P) at k = 1 of the kept posterior
    (gf_giekf_modulator_nmf.m:128-131).  Pass gates: a non-finite pass, or
    one whose NLL regressed past ``accept_tol``, leaves the kept posterior
    as it was; the next pass restarts from it either way."""
    full_fp32()
    _, params, y, mask = place_inputs(params, y, mask, device)
    A, Q, Pinf, Hd = dense_model(model.build_ssm(params))
    m0, P0 = torch.zeros((A.shape[0],), dtype=A.dtype, device=A.device), Pinf

    ms = Ps = nll = None
    for g in range(config.g_iter):
        ms_g, Ps_g, nll_g, good = _giekf_pass(model, params, y, mask, A, Q, Hd, m0, P0, config)
        if ms is None:
            ms, Ps, nll = ms_g, Ps_g, nll_g
        else:
            if config.accept_tol >= 0.0:
                good = good & (nll_g <= nll + config.accept_tol * torch.abs(nll))
            ms = torch.where(good, ms_g, ms)
            Ps = torch.where(good, Ps_g, Ps)
            nll = torch.where(good, nll_g, nll)
        m0, P0 = ms[0], Ps[0]

    Eft = ms @ Hd.T  # (T, C)
    Varft = torch.einsum("ci,tij,cj->tc", Hd, Ps, Hd)
    return GIEKFResult(Eft=Eft, Varft=Varft, ms=ms, Ps=Ps, nll=nll)


def giekf_energy(
    model: GTNMFModel,
    params: GTNMFParams,
    y: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    config: GIEKFConfig = GIEKFConfig(),
    device=None,  # None = the card; "cpu" runs on the CPU
) -> torch.Tensor:
    """Innovation NLL (energy mode): one plain-EKF pass from the prior (one
    linearization at the predicted mean a step, gf_giekf_modulator_nmf.m:
    373-430, so l_iter = 1 whatever the config), a 0-d tensor
    differentiable by autograd.  NaN if the divergence guard rejected any
    observed step (the reference's non-PSD S rejection, :382-391): dropping
    those steps would understate the energy and draw learning toward
    pathological hyperparameters."""
    full_fp32()
    _, params, y, mask = place_inputs(params, y, mask, device)
    A, Q, Pinf, Hd = dense_model(model.build_ssm(params))
    m0 = torch.zeros((A.shape[0],), dtype=A.dtype, device=A.device)
    _, _, nll, n_rejected = _filter(model, params.W, params.lik, A, Q, Hd, y, mask, m0, Pinf, 1)
    return torch.where(n_rejected > 0, torch.full_like(nll, float("nan")), nll)
