"""Plain reference of the benchmarked training path: the ADF energy of the
GT-NMF model (Wilkinson et al., ICML 2019) and its gradient in the
unconstrained hyperparameters.

Written from the model's equations: the constrained hyperparameters from the
scaled sigmoid of ``unpack_params.m`` and the state space assembled again from
them in float64 torch (the exponential x cosine subbands of
``ss_modulators_nmf.m``, the Matern-5/2 modulators, A = expm(F), Q = Pinf -
A Pinf A' with Pinf in closed form); then the ADF sweep one step at a time in
numpy, whose energy is -sum_t lZ_t, and its reverse pass written out step by
step (autograd over 16 000 steps of small tensors takes minutes); the
cotangents it gives A, Q, Pinf and W go back through the assembly by
autograd.  It imports nothing of the program under test; the sigma points
are those of ``reference.py``.

What it follows, as the benchmarked program does, and where that departs
from the paper:

- the energy of one ADF sweep (``ep_itts = 1``, the reference's
  ``ep_itts_train``) from zero sites, each site matched at the forward
  filter's predicted marginal with fraction 1 and damping ``damp`` (the
  port's default, 0.5, which ``fit_hyperparams`` keeps at one sweep), clamp
  ttau >= 0; the reference's ``train_model.m`` scores its energy by its EP
  code's own damping;
- gradients by reverse mode; the reference's fminunc takes finite
  differences (``train_model.m:222-246``);
- the constrained groups of ``SPECS`` as x = lo + (hi - lo) sigmoid(u), the
  rest fixed at the given values;
- the Joseph form of the covariance update (the same function as the
  downdate, which the reverse pass differentiates; it keeps the float32
  control finite).

``Arith`` fixes the sweep's working precision as in ``reference.py``; under
the control's (float32, TF32) every product of both passes rounds its
operands to TF32.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark import reference as R

LEAVES = ("lik", "sub_var", "sub_len", "omega", "mod_var", "mod_len", "W")


# ---------------------------------------------------------------------------
# Constrained hyperparameters (sigmoid.m, unpack_params.m)
# ---------------------------------------------------------------------------


def to_unconstrained(x, lo: float, hi: float):
    """logit((x - lo) / (hi - lo)), float64 numpy."""
    p = (np.asarray(x, np.float64) - lo) / (hi - lo)
    return np.log(p) - np.log1p(-p)


def to_constrained(u, lo: float, hi: float):
    return lo + (hi - lo) * torch.sigmoid(u)


# ---------------------------------------------------------------------------
# State space, differentiable in its hyperparameters
# ---------------------------------------------------------------------------


def _mat(rows):
    return torch.stack([torch.stack(r) for r in rows])


def kernel_sde(kind: str, var, ell):
    """(F, H, Pinf) of the exponential or the Matern-5/2 kernel's SDE from
    0-d tensors; the white noise is implied by the stationary
    discretisation."""
    z, one = 0.0 * ell, 0.0 * ell + 1.0
    if kind == "exp":
        return (-1.0 / ell)[None, None], one[None], var[None, None]
    if kind == "matern52":
        lam = math.sqrt(5.0) / ell
        k = 5.0 / 3.0 * var / ell**2
        return (_mat([[z, one, z], [z, z, one], [-lam**3, -3.0 * lam**2, -3.0 * lam]]),
                torch.stack([one, z, z]),
                _mat([[var, z, -k], [z, k, z], [-k, z, 25.0 * var / ell**4]]))
    raise ValueError(f"no state space for kernel {kind!r}")


def _pad(M, bs: int):
    n = M.shape[-1]
    return torch.nn.functional.pad(M, (0, bs - n) if M.dim() == 1 else (0, bs - n, 0, bs - n))


def ssm(x: dict, kernel1: str, kernel2: str):
    """Discrete model (A, Q, Pinf (C, bs, bs), H (C, bs)) of one file from
    hyperparameter tensors ``x`` (lik, sub_var, sub_len, omega, mod_var,
    mod_len); subbands (kernel1 x cosine) then modulators, zero-padded to one
    block size; differentiable in every entry of ``x``."""
    blocks = []
    for v, ell, om in zip(x["sub_var"], x["sub_len"], x["omega"]):
        F1, H1, P1 = kernel_sde(kernel1, v, ell)
        tau = F1.shape[0]
        I2 = torch.eye(2, dtype=F1.dtype)
        z = 0.0 * om
        rot = _mat([[z, -om], [om, z]])
        F = torch.kron(F1, I2) + torch.kron(torch.eye(tau, dtype=F1.dtype), rot)
        H = torch.kron(H1, torch.tensor([1.0, 0.0], dtype=F1.dtype))
        blocks.append((F, torch.kron(P1, I2), H))
    for v, ell in zip(x["mod_var"], x["mod_len"]):
        F2, H2, P2 = kernel_sde(kernel2, v, ell)
        blocks.append((F2, P2, H2))
    bs = max(b[0].shape[0] for b in blocks)
    F, Pinf, H = (torch.stack([_pad(b[i], bs) for b in blocks]) for i in range(3))
    A = torch.linalg.matrix_exp(F)
    Q = Pinf - A @ Pinf @ A.transpose(-1, -2)
    return A, 0.5 * (Q + Q.transpose(-1, -2)), Pinf, H


# ---------------------------------------------------------------------------
# The ADF energy and its reverse pass, one step at a time
# ---------------------------------------------------------------------------


class Lik:
    """The tilted moments of y ~ N(sum_d a_d z_d, noise), a =
    sqrt(W softplus(g)) (the 'sq' variant), at one step under q = N(mu,
    diag(s2)) by the degree-9 rule (``reference.ut9``), and their
    vector-Jacobian product; numpy arrays in ``ar``'s precision."""

    def __init__(self, D: int, N: int, link: str, variant: str, ar: R.Arith):
        if (link, variant) != ("softplus", "sq"):
            raise ValueError(f"no likelihood for link {link!r}, variant {variant!r}")
        wn, xi = R.ut9(N)
        self.D, self.ar = D, ar
        self.wn, self.xi = ar.array(wn), ar.array(xi)
        self.log_floor = math.log(R.Z_FLOOR)

    def moments(self, y, mu, s2, Wt, noise):
        """lZ, dlZ (C,), d2lZ (C,) and what ``vjp`` reads."""
        ar, D = self.ar, self.D
        mz, mg, vz, vg = mu[:D], mu[D:], s2[:D], s2[D:]
        sg = np.sqrt(vg)
        xn = mg + sg * self.xi  # (S, N)
        L = np.logaddexp(xn, 0.0)
        a0 = ar.mm(L, Wt)  # (S, D)
        a2 = np.maximum(a0, R.SQ_FLOOR)
        a = np.sqrt(a2)
        s2e = ar.mv(a2, vz) + noise
        r = y - ar.mv(a, mz)
        ln = -0.5 * (r * r / s2e + np.log(s2e) + R.LOG2PI)
        lmax = ln.max()
        e = self.wn * np.exp(ln - lmax)
        Z0 = max(e.sum(), ar.tiny)
        lZ_raw = lmax + np.log(Z0)
        floored = lZ_raw < self.log_floor
        lZ = max(lZ_raw, self.log_floor)
        w = e * (np.exp(lZ_raw - lZ) / Z0)  # the normalised weights, unless floored
        rs = r / s2e
        q = rs * rs - 1.0 / s2e
        dz = ar.vm(w * rs, a)
        dmu = self.xi / sg  # (xn - mg) / vg
        g1 = ar.vm(w, dmu)
        g2 = ar.vm(w, dmu * dmu - 1.0 / vg)
        d2z = ar.vm(w * q, a2) - dz * dz
        cache = (mz, vz, vg, sg, xn, L, a0, a, a2, s2e, r, w, floored, rs, q, dz, dmu, g1, Wt)
        return lZ, np.concatenate([dz, g1]), np.concatenate([d2z, g2 - g1 * g1]), cache

    def vjp(self, cache, lZ_b, dl_b, d2l_b):
        """(mu_b, s2_b, Wt_b, noise_b) from the cotangents of lZ, dlZ, d2lZ."""
        ar, D = self.ar, self.D
        mz, vz, vg, sg, xn, L, a0, a, a2, s2e, r, w, floored, rs, q, dz, dmu, g1, Wt = cache
        U_b, g2_b = d2l_b[:D], d2l_b[D:]
        dz_b = dl_b[:D] - 2.0 * dz * U_b
        g1_b = dl_b[D:] - 2.0 * g1 * g2_b
        a_dz = ar.mv(a, dz_b)
        a2_U = ar.mv(a2, U_b)
        w_b = rs * a_dz + q * a2_U + ar.mv(dmu, g1_b) + ar.mv(dmu * dmu - 1.0 / vg, g2_b)
        a_b = (w * rs)[:, None] * dz_b
        a2_b = (w * q)[:, None] * U_b
        q_b = w * a2_U
        rs_b = w * a_dz + 2.0 * rs * q_b
        dmu_b = w[:, None] * (g1_b + 2.0 * dmu * g2_b)
        vg_b = g2_b * w.sum() / (vg * vg)
        sg_b = -(dmu_b * self.xi).sum(0) / (sg * sg)
        r_b = rs_b / s2e
        s2e_b = q_b / (s2e * s2e) - rs_b * r / (s2e * s2e)
        ln_b = w * w_b
        if not floored:
            ln_b = ln_b - w * (w * w_b).sum() + lZ_b * w
        r_b = r_b - ln_b * r / s2e
        s2e_b = s2e_b + 0.5 * ln_b * (r * r / (s2e * s2e) - 1.0 / s2e)
        a_b = a_b - r_b[:, None] * mz
        mz_b = -ar.vm(r_b, a)
        a2_b = a2_b + s2e_b[:, None] * vz
        vz_b = ar.vm(s2e_b, a2)
        a0_b = (a2_b + a_b / (2.0 * a)) * (a0 > R.SQ_FLOOR)
        L_b = ar.mm(a0_b, Wt.T)
        Wt_b = ar.mm(L.T, a0_b)
        xn_b = L_b * 0.5 * (1.0 + np.tanh(0.5 * xn))  # softplus' = sigmoid
        sg_b = sg_b + (xn_b * self.xi).sum(0)
        vg_b = vg_b + sg_b / (2.0 * sg)
        return (np.concatenate([mz_b, xn_b.sum(0)]), np.concatenate([vz_b, vg_b]), Wt_b,
                s2e_b.sum())


def _step(ar, lik: Lik, model, m, P, y, Wt, sn2, damp: float):
    """One ADF step from the filtered (m, P) before it: the new (m, P), lZ
    and what ``_step_vjp`` reads."""
    A, At, Q, H, eye = model
    mp = ar.mv(A, m)
    Pp = ar.mm(ar.mm(A, P), At) + Q
    fmu = (H * mp).sum(-1)
    PH = ar.mv(Pp, H)
    HPH = (H * PH).sum(-1)
    lZ, dl, d2l, mc = lik.moments(y, fmu, HPH, Wt, sn2)
    den = 1.0 + d2l * HPH
    tt_raw = -damp * d2l / den
    tt = np.maximum(tt_raw, 0.0)
    tn = damp * (dl - fmu * d2l) / den
    z = tt * HPH + 1.0
    c = (tt * fmu - tn) / z
    m1 = mp - PH * c[:, None]
    # Joseph form (I - K H) Pp (I - K H)' + K K' / tt, K = Pp H tt / z: the
    # downdate Pp - (tt / z) PH PH', written as a sum of two covariances
    IKH = eye - (PH * (tt / z)[:, None])[:, :, None] * H[:, None, :]
    P1 = ar.mm(ar.mm(IKH, Pp), IKH.swapaxes(-1, -2)) \
        + (tt / (z * z))[:, None, None] * (PH[:, :, None] * PH[:, None, :])
    return m1, P1, lZ, (fmu, PH, HPH, dl, d2l, den, tt_raw, tt, tn, z, c, mc)


def _step_vjp(ar, lik: Lik, model, m, P, cache, m1_b, P1_b, damp: float, grads):
    """The cotangents of (m, P) before a step from those of its (m, P) and
    of its lZ (-1: the energy is -sum lZ); adds the step's share of A, Q,
    Wt and sn2's cotangents to ``grads``.  Differentiates the downdate form
    of the update, the same function of (Pp, tt) as the Joseph form."""
    A, At, Q, H, eye = model
    fmu, PH, HPH, dl, d2l, den, tt_raw, tt, tn, z, c, mc = cache
    s = tt / z
    c_b = -(m1_b * PH).sum(-1)
    s_b = -(ar.mv(P1_b, PH) * PH).sum(-1)
    PH_b = -m1_b * c[:, None] - s[:, None] * ar.mv(P1_b + P1_b.swapaxes(-1, -2), PH)
    z_b = -c_b * c / z - s_b * s / z
    tt_b = c_b * fmu / z + s_b / z + z_b * HPH
    fmu_b = c_b * tt / z
    tn_b = -c_b / z
    HPH_b = z_b * tt
    raw_b = tt_b * (tt_raw > 0.0)
    den_b = -tn_b * tn / den - raw_b * tt_raw / den
    dl_b = tn_b * damp / den
    d2l_b = -(tn_b * fmu + raw_b) * damp / den + den_b * HPH
    fmu_b = fmu_b - tn_b * damp * d2l / den
    HPH_b = HPH_b + den_b * d2l
    mu_b, s2_b, Wt_b, sn2_b = lik.vjp(mc, -1.0, dl_b, d2l_b)
    fmu_b = fmu_b + mu_b
    HPH_b = HPH_b + s2_b
    PH_b = PH_b + HPH_b[:, None] * H
    Pp_b = P1_b + PH_b[:, :, None] * H[:, None, :]
    mp_b = m1_b + fmu_b[:, None] * H
    AP = ar.mm(A, P)
    grads["A"] += ar.mm(Pp_b + Pp_b.swapaxes(-1, -2), AP) + mp_b[:, :, None] * m[:, None, :]
    grads["Q"] += Pp_b
    grads["Wt"] += Wt_b
    grads["sn2"] += sn2_b
    return ar.mv(At, mp_b), ar.mm(ar.mm(At, Pp_b), A)


def adf_energy_vjp(A, Q, Pinf, H, Wt, sn2, y, lik: Lik, damp: float):
    """-sum_t lZ_t of one ADF sweep from zero sites over a fully observed
    signal y (T,), and its cotangents in A, Q, Pinf (C, bs, bs), Wt (N, D)
    and sn2: the sweep forward, then its reverse pass from the last step,
    each step's forward recomputed from the (m, P) stored before it.  numpy
    in ``lik.ar``'s precision."""
    ar = lik.ar
    model = (A, A.swapaxes(-1, -2), Q, H, np.eye(H.shape[-1], dtype=A.dtype))
    T = y.shape[0]
    ms = np.empty((T,) + H.shape, A.dtype)
    Ps = np.empty((T,) + A.shape, A.dtype)
    lZ = np.empty(T, A.dtype)
    m, P = 0.0 * H, Pinf
    for t in range(T):
        ms[t], Ps[t] = m, P
        m, P, lZ[t], _ = _step(ar, lik, model, m, P, y[t], Wt, sn2, damp)
    grads = {"A": np.zeros_like(A), "Q": np.zeros_like(Q), "Wt": np.zeros_like(Wt),
             "sn2": np.zeros((), A.dtype)}
    m_b, P_b = np.zeros_like(H), np.zeros_like(A)
    for t in range(T - 1, -1, -1):
        _, _, _, cache = _step(ar, lik, model, ms[t], Ps[t], y[t], Wt, sn2, damp)
        m_b, P_b = _step_vjp(ar, lik, model, ms[t], Ps[t], cache, m_b, P_b, damp, grads)
    grads["Pinf"] = P_b  # the state before step 0 is (0, Pinf)
    return -lZ.sum(), grads


def energy_and_grad(u: dict, fixed: dict, specs: dict, model: dict, y, damp: float,
                    ar: R.Arith = R.F64):
    """The ADF energy at unconstrained values ``u`` (group -> float64 numpy)
    with the other groups at ``fixed`` (natural scale), and its gradient in
    ``u``: (energy, {group: gradient}), float64.  The hyperparameters and the
    state space are formed in float64 torch and cast to ``ar``'s precision
    for the sweep, as the program forms its own; the sweep's cotangents go
    back through them by autograd."""
    an = ar.like("numpy")
    with torch.inference_mode(False), torch.enable_grad():
        leaves = {g: torch.tensor(np.asarray(v, np.float64), requires_grad=True)
                  for g, v in u.items()}
        x = {g: to_constrained(leaves[g], *specs[g]) if g in leaves
             else torch.as_tensor(np.asarray(fixed[g], np.float64)) for g in LEAVES}
        A, Q, Pinf, H = ssm(x, model["kernel1"], model["kernel2"])
        Wt, sn2 = x["W"].T, x["lik"]
        D, N = x["W"].shape
        lik = Lik(D, N, model["link"], model["variant"], an)
        E, g = adf_energy_vjp(*(an.array(t.detach()) for t in (A, Q, Pinf, H, Wt, sn2)),
                              an.array(np.asarray(y, np.float64)), lik, damp)
        pairs = [(t, torch.as_tensor(np.asarray(g[k], np.float64)))
                 for t, k in zip((A, Q, Pinf, Wt, sn2), ("A", "Q", "Pinf", "Wt", "sn2"))
                 if t.requires_grad]
        grads = torch.autograd.grad([t for t, _ in pairs], list(leaves.values()),
                                    [c for _, c in pairs])
    return float(E), {k: gr.numpy() for k, gr in zip(leaves, grads)}


# ---------------------------------------------------------------------------
# Adam (torch.optim.Adam's defaults), float64
# ---------------------------------------------------------------------------


def adam(u0: np.ndarray, grads: np.ndarray, lr: float, betas=(0.9, 0.999),
         eps: float = 1e-8) -> np.ndarray:
    """The parameters after Adam's updates with the given gradients, one row
    of ``grads`` a step, from ``u0``; the update of ``torch.optim.Adam``
    (bias-corrected moments, eps added to the corrected root), float64."""
    u = np.asarray(u0, np.float64).copy()
    m, v = np.zeros_like(u), np.zeros_like(u)
    b1, b2 = betas
    for t, g in enumerate(np.asarray(grads, np.float64), start=1):
        m = b1 * m + (1.0 - b1) * g
        v = b2 * v + (1.0 - b2) * g * g
        denom = np.sqrt(v) / math.sqrt(1.0 - b2**t) + eps
        u = u - (lr / (1.0 - b1**t)) * m / denom
    return u
