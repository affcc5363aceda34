"""Plain reference of the benchmarked inference paths.

Power EP for the GT-NMF model family (Wilkinson et al., ICML 2019), written
from the model's equations in plain PyTorch: the state space is assembled
again from the hyperparameters, sweep 1 is the ADF recursion one step at a
time, and the later sweeps re-site every step at its smoothed cavity and then
run the fixed-site filter and RTS smoother as associative scans over time
(Saerkkae and Garcia-Fernandez, "Temporal parallelization of Bayesian
smoothers", 2021).  It imports nothing of the program under test.

What it follows, as the benchmarked program does:

- the stationary discretisation A = expm(F), Q = Pinf - A Pinf A', and the
  first prediction from (0, Pinf);
- sweep 1 matches each site at the forward filter's predicted marginal, with
  fraction 1, damping ``damping[0]`` and zero incoming sites;
- later sweeps re-site every step (the last one too) at the smoothed cavity
  with the EP fraction, damping ``damping[itt]``, clamp ttau >= 0, update only
  sites with a positive cavity variance;
- the tilted moments by the fully symmetric cubature rule of degree 9
  (McNamee and Stenger 1967) with the raw-scale floor Z >= 1e-10;
- 'sq' amplitudes sqrt(max(W link(g), 1e-12)).

``Arith`` fixes the working precision.  ``Arith()`` (float64) is the
reference.  ``Arith("float32", tf32=True)`` is the control: every matrix
product rounds its operands to TF32 (10 bits of mantissa) and accumulates in
float32, as the card's tensor cores do when TF32 is allowed.
"""

from __future__ import annotations

import math
from itertools import combinations, permutations, product

import numpy as np
import torch

LOG2PI = math.log(2.0 * math.pi)
Z_FLOOR = 1e-10
SQ_FLOOR = 1e-12


# ---------------------------------------------------------------------------
# Arithmetic
# ---------------------------------------------------------------------------


def tf32_round(x):
    """float32 -> nearest TF32 value (round half to even on 13 dropped bits);
    a numpy array or a torch tensor."""
    if isinstance(x, np.ndarray):
        i = np.ascontiguousarray(x, np.float32).view(np.int32)
        return ((i + 0x0FFF + ((i >> 13) & 1)) & -0x2000).view(np.float32)
    i = x.contiguous().view(torch.int32)
    return ((i + 0x0FFF + ((i >> 13) & 1)) & -0x2000).view(torch.float32)


class Arith:
    """Working precision and array library of a reference run.

    ``dtype``: "float64" (the reference) or "float32"; ``tf32``: every matrix
    product rounds its operands to TF32; ``lib``: "torch", or "numpy" for the
    step-by-step sweep, whose small arrays numpy handles with less overhead.
    The few operations whose names differ between the two libraries are
    methods here."""

    def __init__(self, dtype: str = "float64", tf32: bool = False, lib: str = "torch"):
        if tf32 and dtype != "float32":
            raise ValueError("TF32 products take float32 operands")
        self.name, self.tf32, self.lib = dtype, tf32, lib
        self.xp = np if lib == "numpy" else torch
        self.dtype = np.dtype(dtype) if lib == "numpy" else getattr(torch, dtype)
        self.tiny = float(np.finfo(dtype).tiny)

    def like(self, lib: str) -> "Arith":
        return Arith(self.name, self.tf32, lib)

    def array(self, x, device=None):
        if self.lib == "numpy":
            x = x.cpu().numpy() if torch.is_tensor(x) else x
            return np.asarray(x, dtype=self.dtype)
        return torch.as_tensor(np.asarray(x) if isinstance(x, (list, tuple)) else x,
                               dtype=self.dtype, device=device)

    def empty(self, shape, like):
        if self.lib == "numpy":
            return np.empty(shape, self.dtype)
        return torch.empty(shape, dtype=self.dtype, device=like.device)

    def mm(self, a, b):
        if self.tf32:
            return tf32_round(a) @ tf32_round(b)
        return a @ b

    def mv(self, M, v):
        return self.mm(M, v[..., None])[..., 0]

    def vm(self, v, M):
        return self.mm(v[..., None, :], M)[..., 0, :]

    def floor(self, x, c: float):
        return np.maximum(x, c) if self.lib == "numpy" else torch.clamp_min(x, c)

    def softplus(self, x):
        return np.logaddexp(x, 0.0) if self.lib == "numpy" else \
            torch.logaddexp(x, torch.zeros_like(x))

    def amax(self, x):
        return x.max(-1, keepdims=True) if self.lib == "numpy" else x.amax(-1, keepdim=True)

    def cat(self, xs):
        return np.concatenate(xs, -1) if self.lib == "numpy" else torch.cat(xs, -1)


F64 = Arith()


# ---------------------------------------------------------------------------
# State space (cf_*_to_ss.m, ss_modulators_nmf.m)
# ---------------------------------------------------------------------------


def kernel_sde(kind: str, var: float, ell: float):
    """(F, H, Pinf) of a Matern kernel's SDE, float64 numpy; its white-noise
    term is implied by the stationary discretisation."""
    if kind == "exp":
        return np.array([[-1.0 / ell]]), np.array([1.0]), np.array([[var]])
    if kind == "matern32":
        lam = math.sqrt(3.0) / ell
        F = np.array([[0.0, 1.0], [-lam**2, -2.0 * lam]])
        return F, np.array([1.0, 0.0]), np.diag([var, 3.0 * var / ell**2])
    if kind == "matern52":
        lam = math.sqrt(5.0) / ell
        F = np.array([[0.0, 1.0, 0.0], [0.0, 0.0, 1.0], [-lam**3, -3.0 * lam**2, -3.0 * lam]])
        k = 5.0 / 3.0 * var / ell**2
        Pinf = np.array([[var, 0.0, -k], [0.0, k, 0.0], [-k, 0.0, 25.0 * var / ell**4]])
        return F, np.array([1.0, 0.0, 0.0]), Pinf
    raise ValueError(f"no state space for kernel {kind!r}")


def channel_blocks(w: dict, kernel1: str, kernel2: str):
    """Per-channel (F, Pinf, H) blocks, subbands (kernel1 x cosine) then
    modulators, zero-padded to one block size.  Returns numpy F, Pinf
    (C, bs, bs), H (C, bs) and pad (C, bs), 1 on padded dims."""
    blocks = []
    for v, ell, om in zip(w["sub_var"], w["sub_len"], w["omega"]):
        F1, H1, P1 = kernel_sde(kernel1, float(v), float(ell))
        tau = F1.shape[0]
        rot = np.array([[0.0, -float(om)], [float(om), 0.0]])
        F = np.kron(F1, np.eye(2)) + np.kron(np.eye(tau), rot)
        blocks.append((F, np.kron(P1, np.eye(2)), np.kron(H1, [1.0, 0.0])))
    for v, ell in zip(w["mod_var"], w["mod_len"]):
        F2, H2, P2 = kernel_sde(kernel2, float(v), float(ell))
        blocks.append((F2, P2, H2))
    bs = max(b[0].shape[0] for b in blocks)
    C = len(blocks)
    F, Pinf = np.zeros((C, bs, bs)), np.zeros((C, bs, bs))
    H, pad = np.zeros((C, bs)), np.ones((C, bs))
    for c, (Fc, Pc, Hc) in enumerate(blocks):
        t = Fc.shape[0]
        F[c, :t, :t], Pinf[c, :t, :t], H[c, :t], pad[c, :t] = Fc, Pc, Hc, 0.0
    return F, Pinf, H, pad


class SSM:
    """Discrete model of a batch of files: A, Q, Pinf (B, C, bs, bs), H and
    pad (B, C, bs), torch; assembled and discretised in float64, then cast."""

    def __init__(self, weights: list, kernel1: str, kernel2: str, ar: Arith, device):
        parts = [channel_blocks(w, kernel1, kernel2) for w in weights]
        F, Pinf, H, pad = (torch.as_tensor(np.stack(x), dtype=torch.float64)
                           for x in zip(*parts))
        A = torch.linalg.matrix_exp(F)
        Q = Pinf - A @ Pinf @ A.transpose(-1, -2)
        Q = 0.5 * (Q + Q.transpose(-1, -2))
        cast = lambda x: x.to(device=device, dtype=ar.dtype)
        self.A, self.Q, self.Pinf, self.H, self.pad = map(cast, (A, Q, Pinf, H, pad))


# ---------------------------------------------------------------------------
# Cubature (ut9_ws.m with the McNamee-Stenger sign of the third-order term)
# ---------------------------------------------------------------------------


def _sym_set(n: int, gen: tuple) -> np.ndarray:
    """Every distinct signed permutation of ``gen`` in n dims, (S, n)."""
    if not gen:
        return np.zeros((1, n))
    pts = set()
    for pos in combinations(range(n), len(gen)):
        for perm in set(permutations(gen)):
            for signs in product((1.0, -1.0), repeat=len(gen)):
                x = [0.0] * n
                for p, g, s in zip(pos, perm, signs):
                    x[p] = s * g
                pts.add(tuple(x))
    return np.array(sorted(pts))


def _nk(n: int, k: int) -> float:
    return math.comb(n, k) if n >= k >= 0 else 0.0


def ut9(n: int):
    """Degree-9 fully symmetric rule for N(0, I_n): weights (S,), points (S, n)."""
    I2222, I224, I222, I44, I26, I24, I22 = 1.0, 3.0, 1.0, 9.0, 15.0, 3.0, 1.0
    I8, I6, I4, I2, I0 = 105.0, 15.0, 3.0, 1.0, 1.0
    r = np.roots([I4**2 - I2 * I6, 0.0, -(I4 * I6 - I2 * I8), 0.0, I6**2 - I4 * I8])
    r = np.real(r[np.real(r) > 0])
    u, v = float(r[0]), float(r[1])
    u2, u4, u6, u8 = u**2, u**4, u**6, u**8
    v2, v4, v6, v8 = v**2, v**4, v**6, v**8
    A1111 = I2222 / 16.0 / u8
    M68 = np.array([[u6, v6], [u8, v8]])
    A111, A222 = np.linalg.solve(
        M68, np.array([I222, I224]) - 16.0 * (n - 3) * A1111 * np.array([u6, u8])) / 8.0
    A12 = (I26 - I44) / (4.0 * u2 * v2 * (u2 - v2) ** 2)
    A11, A22 = -2.0 * (n - 2) * np.array([A111, A222]) + 0.25 * np.linalg.solve(
        M68, np.array([I24, I26]) - 4.0 * np.array([u4 * v2 + u2 * v4, u6 * v2 + u2 * v6]) * A12
        - 16.0 * _nk(n - 2, 2) * np.array([u6, u8]) * A1111)
    A1, A2 = (-2.0 * (n - 1) * np.array([A11 + A12, A22 + A12])
              - 4.0 * _nk(n - 1, 2) * np.array([A111, A222])
              + 0.5 * np.linalg.solve(np.array([[u2, v2], [u4, v4]]),
                                      np.array([I2, I4]) - 16.0 * _nk(n - 1, 3)
                                      * np.array([u2, u4]) * A1111))
    A0 = (I0 - 2 * n * (A1 + A2) - 4 * _nk(n, 2) * (A11 + 2 * A12 + A22)
          - 8 * _nk(n, 3) * (A111 + A222) - 16 * _nk(n, 4) * A1111)
    sets = [((), A0), ((u,), A1), ((v,), A2), ((u, u), A11), ((u, v), A12), ((v, v), A22),
            ((u, u, u), A111), ((v, v, v), A222), ((u, u, u, u), A1111)]
    sets = [(_sym_set(n, g), a) for g, a in sets if len(g) <= n]
    return (np.concatenate([np.full(len(s), a) for s, a in sets]),
            np.concatenate([s for s, _ in sets]))


# ---------------------------------------------------------------------------
# The likelihood: y ~ N(sum_d a_d z_d, sn2), a = W link(g) ('amp') or its root
# ---------------------------------------------------------------------------


class Lik:
    """The moment match of one model family: sigma points, link, variant."""

    def __init__(self, D: int, N: int, link: str, variant: str, ar: Arith, device=None):
        if link not in ("softplus", "exp"):
            raise ValueError(f"no link {link!r}")
        wn, xi = ut9(N)
        self.D, self.N = D, N
        self.wn, self.xi = ar.array(wn, device), ar.array(xi, device)
        self.link = ar.softplus if link == "softplus" else ar.xp.exp
        self.sq = variant == "sq"
        self.ar = ar
        self.log_floor = math.log(Z_FLOOR)

    @property
    def S(self) -> int:
        return self.wn.shape[0]

    def amplitudes(self, g, Wt):
        """(..., N) modulator values -> (..., D) amplitudes; Wt (B, N, D)."""
        a = self.ar.mm(self.link(g), Wt)
        return self.ar.xp.sqrt(self.ar.floor(a, SQ_FLOOR)) if self.sq else a

    def moments(self, y, mu, s2, Wt, noise):
        """lZ (...,), dlZ and d2lZ (..., D+N) of log E_q N(y | a'z, noise)
        under q = N(mu, diag(s2)); the file axis is last of the leading axes
        of y, and Wt (B, N, D) and ``noise`` (B,), sn2 / fraction, run along it."""
        ar, xp, D = self.ar, self.ar.xp, self.D
        mu_z, mu_g = mu[..., :D], mu[..., D:]
        s2_z, s2_g = s2[..., :D], s2[..., D:]
        xn = mu_g[..., None, :] + xp.sqrt(ar.floor(s2_g, 0.0))[..., None, :] * self.xi
        a = self.amplitudes(xn, Wt)  # (..., S, D)
        a2 = a * a
        s2e = ar.mv(a2, s2_z) + noise[..., None]
        resid = y[..., None] - ar.mv(a, mu_z)
        log_norm = -0.5 * (resid * resid / s2e + xp.log(s2e) + LOG2PI)
        lmax = ar.amax(log_norm)
        lmax = xp.where(xp.isfinite(lmax), lmax, 0.0 * lmax)
        wns = self.wn * xp.exp(log_norm - lmax)
        Z0 = ar.floor(wns.sum(-1), ar.tiny)
        lZ_raw = lmax[..., 0] + xp.log(Z0)
        lZ = ar.floor(lZ_raw, self.log_floor)
        Zi = (xp.exp(lZ_raw - lZ) / Z0)[..., None]
        rs = resid / s2e
        dz = Zi * ar.vm(wns * rs, a)
        d2z = Zi * ar.vm(wns * (rs * rs - 1.0 / s2e), a2) - dz * dz
        s2g = s2_g[..., None, :]
        dmu = (xn - mu_g[..., None, :]) / s2g
        gs = Zi * ar.vm(wns, ar.cat([dmu, dmu * dmu - 1.0 / s2g]))
        dg, d2g = gs[..., : self.N], gs[..., self.N:]
        return lZ, ar.cat([dz, dg]), ar.cat([d2z, d2g - dg * dg])


# ---------------------------------------------------------------------------
# Sweep 1: ADF, one step at a time
# ---------------------------------------------------------------------------


def adf_sweep(model, lik: Lik, Wt, sn2, y, obs, damp: float):
    """Filter with in-step site matching from zero sites, in ``lik.ar``'s
    library.  model: (A, Q, Pinf (B, C, bs, bs), H (B, C, bs)); y, obs
    (T, B), obs 0 or 1; Wt (B, N, D); sn2 (B,).  Returns filtered ms
    (T, B, C, bs), Ps (T, B, C, bs, bs), lZ (T, B), ttau, tnu (T, B, C)."""
    ar, xp = lik.ar, lik.ar.xp
    A, Q, Pinf, H = model
    At = A.swapaxes(-1, -2)
    T = y.shape[0]
    B, C, bs = H.shape
    m = 0.0 * H
    P = Pinf
    eye = 0.0 * Pinf + (np.eye(bs) if ar.lib == "numpy" else torch.eye(bs, dtype=H.dtype,
                                                                       device=H.device))
    ms, Ps = ar.empty((T, B, C, bs), H), ar.empty((T, B, C, bs, bs), H)
    lZs, tts, tns = ar.empty((T, B), H), ar.empty((T, B, C), H), ar.empty((T, B, C), H)
    for t in range(T):
        mp = ar.mv(A, m)
        Pp = ar.mm(ar.mm(A, P), At) + Q
        fmu = (H * mp).sum(-1)
        PH = ar.mv(Pp, H)
        HPH = (H * PH).sum(-1)
        lZ, dlZ, d2lZ = lik.moments(y[t], fmu, HPH, Wt, sn2)
        o = obs[t][:, None]
        denom = 1.0 + d2lZ * HPH
        tt = ar.floor(damp * (-d2lZ / denom), 0.0) * o
        tn = damp * ((dlZ - fmu * d2lZ) / denom) * o
        z = tt * HPH + 1.0
        m = mp - PH * ((tt * fmu - tn) / z)[..., None]
        # Joseph form (I - K H) Pp (I - K H)' + K K' / tt, K = Pp H tt / z:
        # the update Pp - K H Pp, written as a sum of two covariances
        IKH = eye - (PH * (tt / z)[..., None])[..., :, None] * H[..., None, :]
        P = ar.mm(ar.mm(IKH, Pp), IKH.swapaxes(-1, -2)) \
            + (tt / (z * z))[..., None, None] * (PH[..., :, None] * PH[..., None, :])
        ms[t], Ps[t], lZs[t], tts[t], tns[t] = m, P, lZ * o[:, 0], tt, tn
    return ms, Ps, lZs, tts, tns


# ---------------------------------------------------------------------------
# Fixed-site passes as associative scans over time
# ---------------------------------------------------------------------------


def _outer(u, v):
    return u[..., :, None] * v[..., None, :]


def _sym(M):
    return 0.5 * (M + M.transpose(-1, -2))


def _eye_like(M):
    return torch.eye(M.shape[-1], dtype=M.dtype, device=M.device).expand_as(M)


def scan_filter(ssm: SSM, tt, tn, ar: Arith):
    """Forward filter with fixed sites tt, tn (T, B, C) from the prediction
    (0, Pinf).  Returns filtered ms (T, B, C, bs), Ps (T, B, C, bs, bs)."""
    A, Q, H, Pinf = ssm.A, ssm.Q, ssm.H, ssm.Pinf
    QH = ar.mv(Q, H)  # (B, C, bs)
    HQH = (H * QH).sum(-1)
    HA = ar.vm(H, A)  # h' A
    den = 1.0 + tt * HQH
    s, r = tt / den, tn / den  # (T, B, C)
    IKH = _eye_like(A) - _outer(QH * s[..., None], H)  # (T, B, C, bs, bs)
    Ael = ar.mm(IKH, A)
    bel = QH * r[..., None]
    Cel = Q - s[..., None, None] * _outer(QH, QH)
    Jel = s[..., None, None] * _outer(HA, HA)
    eta = r[..., None] * HA
    # step 0 conditions on nothing: the prediction is (0, Pinf)
    PH = ar.mv(Pinf, H)
    d0 = 1.0 + tt[0] * (H * PH).sum(-1)
    Ael[0] = 0.0
    bel[0] = PH * (tn[0] / d0)[..., None]
    Cel[0] = Pinf - (tt[0] / d0)[..., None, None] * _outer(PH, PH)
    Jel[0] = 0.0
    eta[0] = 0.0
    el = [Ael, bel, Cel, eta, Jel]
    d, T = 1, tt.shape[0]
    while d < T:
        Ai, bi, Ci, ei, Ji = (x[:-d] for x in el)
        Aj, bj, Cj, ej, Jj = (x[d:] for x in el)
        M = _eye_like(Ci) + ar.mm(Ci, Jj)
        X = torch.linalg.solve(M, torch.cat([Ai, (bi + ar.mv(Ci, ej))[..., None], Ci], -1))
        bs = Ai.shape[-1]
        XA, Xb, XC = X[..., :bs], X[..., bs], X[..., bs + 1:]
        Y = torch.linalg.solve(M.transpose(-1, -2),
                               torch.cat([(ej - ar.mv(Jj, bi))[..., None], ar.mm(Jj, Ai)], -1))
        AiT = Ai.transpose(-1, -2)
        new = [ar.mm(Aj, XA), ar.mv(Aj, Xb) + bj,
               _sym(ar.mm(ar.mm(Aj, XC), Aj.transpose(-1, -2)) + Cj),
               ar.mv(AiT, Y[..., 0]) + ei, _sym(ar.mm(AiT, Y[..., 1:]) + Ji)]
        el = [torch.cat([x[:d], n]) for x, n in zip(el, new)]
        d *= 2
    return el[1], el[2]


def scan_smoother(ssm: SSM, ms, Ps, ar: Arith):
    """RTS smoother over a filtered trajectory (T, B, C, bs[, bs]); the last
    step's smoothed state is its filtered one."""
    A, Q = ssm.A, ssm.Q
    At = A.transpose(-1, -2)
    AP = ar.mm(A, Ps)
    Pp = ar.mm(AP, At) + Q + torch.diag_embed(ssm.pad)
    E = torch.linalg.solve(Pp, AP).transpose(-1, -2)  # P A' Pp^-1
    g = ms - ar.mv(E, ar.mv(A, ms))
    L = _sym(Ps - ar.mm(E, AP))
    E[-1], g[-1], L[-1] = 0.0, ms[-1], Ps[-1]
    el = [E, g, L]
    d, T = 1, ms.shape[0]
    while d < T:
        Ek, gk, Lk = (x[:-d] for x in el)
        El, gl, Ll = (x[d:] for x in el)
        new = [ar.mm(Ek, El), ar.mv(Ek, gl) + gk,
               _sym(ar.mm(ar.mm(Ek, Ll), Ek.transpose(-1, -2)) + Lk)]
        el = [torch.cat([n, x[-d:]]) for x, n in zip(el, new)]
        d *= 2
    return el[1], el[2]


def marginals(ssm: SSM, ms, Ps):
    """Observable mean and variance per channel, (T, B, C)."""
    H = ssm.H
    return (ms * H).sum(-1), (Ps * _outer(H, H)).sum((-1, -2))


# ---------------------------------------------------------------------------
# Power EP
# ---------------------------------------------------------------------------


def resite(lik: Lik, Wt, sn2, y, obs, mu, var, tt, tn, frac: float, damp: float,
           chunk: int):
    """Re-match every site at its smoothed cavity; (T, B, C) sites, lZ (T, B)."""
    v_raw = 1.0 / (1.0 / var - frac * tt)
    ok = (v_raw > 0.0) & obs[..., None]
    v_cav = torch.where(ok, v_raw, torch.ones_like(v_raw))
    m_cav = torch.where(ok, v_raw * (mu / var - frac * tn), torch.zeros_like(v_raw))
    outs = [lik.moments(y[i:i + chunk], m_cav[i:i + chunk], v_cav[i:i + chunk], Wt, sn2 / frac)
            for i in range(0, y.shape[0], chunk)]
    lZ, dlZ, d2lZ = (torch.cat(x) for x in zip(*outs))
    lZ = torch.where(obs, lZ, torch.zeros_like(lZ))
    denom = 1.0 + d2lZ * v_cav
    tt_new = (1.0 - damp * frac) * tt + damp * (-d2lZ / denom)
    tn_new = (1.0 - damp * frac) * tn + damp * ((dlZ - m_cav * d2lZ) / denom)
    return (torch.clamp_min(torch.where(ok, tt_new, tt), 0.0), torch.where(ok, tn_new, tn)), lZ


def ep(weights: list, model: dict, y, obs, *, ep_itts: int, ep_fraction: float, damping,
       ar: Arith = F64, sweep: str = "numpy", device="cpu", chunk_elems: int = 1 << 25):
    """Power EP over a batch of files that share one model structure.

    weights: per-file dicts of natural-scale hyperparameters (lik, sub_var,
    sub_len, omega, mod_var, mod_len, W (D, N)); model: kernel1, kernel2,
    link, variant; y, obs (B, T) numpy.  Sweep 1 runs in numpy on the host
    (``sweep="numpy"``) or in torch on ``device``; the scans and re-sites run
    in torch on ``device``.  Returns Eft, Varft (B, T, C) and nlZ
    (B, ep_itts), torch on ``device``."""
    damp = lambda i: damping[min(i, len(damping) - 1)]
    dev = torch.device(device)
    D, N = len(weights[0]["sub_var"]), len(weights[0]["mod_var"])
    link, variant = model.get("link", "softplus"), model["variant"]
    ssm = SSM(weights, model["kernel1"], model["kernel2"], ar, dev)
    lik = Lik(D, N, link, variant, ar, dev)
    Wt_np = np.stack([np.asarray(w["W"], float).T for w in weights])
    sn2_np = np.array([float(w["lik"]) for w in weights])
    obs = np.asarray(obs, bool)
    yT_np = np.where(obs, np.asarray(y, float), 0.0).T
    if sweep == "numpy":
        an = ar.like("numpy")
        mats = tuple(x.cpu().numpy() for x in (ssm.A, ssm.Q, ssm.Pinf, ssm.H))
        out = adf_sweep(mats, Lik(D, N, link, variant, an), an.array(Wt_np), an.array(sn2_np),
                        an.array(yT_np), an.array(obs.T), damp(0))
        ms, Ps, lZ, tt, tn = (torch.as_tensor(x, device=dev) for x in out)
    else:
        ms, Ps, lZ, tt, tn = adf_sweep((ssm.A, ssm.Q, ssm.Pinf, ssm.H), lik,
                                       ar.array(Wt_np, dev), ar.array(sn2_np, dev),
                                       ar.array(yT_np, dev), ar.array(obs.T, dev), damp(0))
    Wt, sn2, yT = ar.array(Wt_np, dev), ar.array(sn2_np, dev), ar.array(yT_np, dev)
    oT = torch.as_tensor(obs.T, device=dev)
    nlZ = [-lZ.sum(0)]
    mu, var = marginals(ssm, *scan_smoother(ssm, ms, Ps, ar))
    del ms, Ps
    chunk = max(1, chunk_elems // (lik.S * (D + N) * len(weights)))
    for itt in range(1, ep_itts):
        (tt, tn), lZ = resite(lik, Wt, sn2, yT, oT, mu, var, tt, tn, ep_fraction, damp(itt),
                              chunk)
        nlZ.append(-lZ.sum(0))
        fm, fP = scan_filter(ssm, tt, tn, ar)
        mu, var = marginals(ssm, *scan_smoother(ssm, fm, fP, ar))
        del fm, fP
    return mu.transpose(0, 1), var.transpose(0, 1), torch.stack(nlZ, 1)


def plug_in(weights: list, model: dict, Eft):
    """Per-subband contributions z_d a_d(g) at the posterior means, (B, T, D),
    in float64."""
    D, N = len(weights[0]["sub_var"]), len(weights[0]["mod_var"])
    lik = Lik(D, N, model.get("link", "softplus"), model["variant"], F64, Eft.device)
    Wt = F64.array(np.stack([np.asarray(w["W"], float).T for w in weights]), Eft.device)
    Eft = Eft.to(torch.float64)
    return Eft[..., :D] * lik.amplitudes(Eft[..., D:], Wt)
