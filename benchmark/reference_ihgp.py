"""Plain reference of the infinite-horizon inference engine.

Infinite-horizon Gaussian processes (Solin, Hensman and Turner, NeurIPS
2018) as the GT-NMF code runs them in Power EP (Wilkinson et al., ICML 2019,
section 5; ``ihgp_ep_modulator_nmf.m:104-442``): every channel's filter runs
at its steady state, looked up by the effective noise R = 1/ttau of its
current site in a table solved once a call over a grid of noise levels.
Written from those equations in plain numpy and PyTorch; it imports nothing
of the program under test and shares with ``reference.py`` only the model's
state space, the cubature and the all-T re-site.

What it follows:

- the coarse bank (:104-128): for each channel, on its own state dimension
  (no padding) balanced to unit prior variances (a similarity; the tables
  come back in the model's coordinates), the filtering DARE
  P = A P A' + Q - A P h (h'P h + r)^-1 h'P A' at
  r = 10**linspace(grid_lo, grid_hi, grid_coarse), by
  ``scipy.linalg.solve_discrete_are`` where scipy is there and the
  precision is float64, else by Newton's iteration on the Riccati equation
  (Hewer) run until it stops moving; a point whose relative residual is
  1e-4 or more (or whose solver fails) is replaced by the nearest converged
  point of its channel, ties to the lower; a channel with none falls back
  to Pinf;
- the forward tables (:130-133): P interpolated cubically (Catmull-Rom, in
  log10 r) to ``grid_fine`` points, then Ph = P h and h'P h, floored at
  1e-10;
- the smoother tables (:150-191), derived at the coarse points and then
  interpolated: Pf = P - r K K' with K = P h / (h'P h + r) (the reference's
  quirk: the noise r in place of the innovation variance),
  G = Pf A' (A Pf A' + Q)^-1, QQ = Pf - G P G' with its negative
  eigenvalues clipped to 0, PS solving PS = G PS G' + QQ (exactly, by the
  Kronecker form); a point where rho(G) >= 1, PS is not finite or its
  residual is 1e-6 or more is patched as above, a channel with none gets
  (G, PS) = (0, Pinf);
- the lookup (:237, :285-289): the nearest grid point in linear r to R,
  ties to the lower; ttau <= 0 (R = inf) takes the top of the grid;
- sweep 1 (:233-310) one step at a time: predict m = A m, match the site
  at the predictive marginal (h m, h'Ph of the PREVIOUS step's lookup, Pinf
  at the first step) with fraction 1 and damping ``damping[0]``, clamp
  ttau >= 0, look the step's table up by the new site, update
  m += Ph_prev (tnu - ttau h m) / (ttau h'Ph_prev + 1): the gain mixes the
  previous step's table with this step's noise, the reference's quirk;
- later sweeps: the same recursion with the sites fixed but the last,
  which is matched again forward (:251) at the sweep's damping;
- the steady smoother (:373-442): ms_k = G_k ms_{k+1} + mf_k - G_k A mf_k,
  G_k from the step's lookup; the variances are h'PS h at that lookup (the
  smoothed-variance form ``pf_correct = 0``);
- between sweeps every site but the last is re-matched at its smoothed
  cavity (``reference.resite``, fraction ``ep_fraction``, the next sweep's
  damping); the per-sweep energy sums those site energies and the last
  site's forward one.

Departures, each also the port's: the grid spans log10 R from ``grid_lo``,
not the reference's fixed -2 (its default does not reach the realised R at
small noise); the interpolation is cubic in log10 r on clamped edges; the
gain is written in the site's natural parameters, algebraically the
reference's K (ys - h m); padded state dimensions carry nothing.

``Arith`` fixes the working precision as in ``reference.py``; the control
(float32, TF32 products) runs Newton's iteration, as scipy solves the DARE in
float64 only.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from benchmark import reference as R

try:
    import scipy.linalg as _sla
except ImportError:  # Newton's iteration stands in
    _sla = None

DARE_TOL = 1e-4  # a coarse point counts as solved below this relative residual
LYAP_TOL = 1e-6  # the smoother stage's
VAR_FLOOR = 1e-10  # the reference takes |.| of negative variances (:493-496)
NEWTON_STEPS = 100  # at most; it converges in far fewer (quadratically)
RESITE_ELEMS = 1 << 25  # cubature terms a re-site chunk holds
TABLE_FIELDS = ("Ph", "hPph", "Gn", "hPSh")


class Grid(NamedTuple):
    lo: float
    hi: float
    coarse: int
    fine: int


class Bank(NamedTuple):
    """The steady-state tables on the fine grid, padded to the block size."""

    log_r: np.ndarray  # (G,)
    Ph: np.ndarray  # (C, G, bs)
    hPph: np.ndarray  # (C, G)
    Gn: np.ndarray  # (C, G, bs, bs)
    hPSh: np.ndarray  # (C, G)
    dare_res: np.ndarray  # (C, Gc) relative residual of each coarse DARE solution
    dare_ok: np.ndarray  # (C, Gc) bool


# ---------------------------------------------------------------------------
# The bank
# ---------------------------------------------------------------------------


def catmull_rom(xg, xq) -> np.ndarray:
    """Weights (len(xq), len(xg)) of cubic convolution (Keys, a = -1/2) from
    the uniform grid ``xg`` to the points ``xq``, edge samples repeated."""
    xg, xq = np.asarray(xg, np.float64), np.asarray(xq, np.float64)
    n = len(xg)
    Wt = np.zeros((len(xq), n))
    for row, q in enumerate(xq):
        u = (q - xg[0]) / (xg[1] - xg[0])
        i = min(max(int(np.floor(u)), 0), n - 2)
        s = u - i
        ws = (0.5 * (-s**3 + 2 * s**2 - s), 0.5 * (3 * s**3 - 5 * s**2 + 2),
              0.5 * (-3 * s**3 + 4 * s**2 + s), 0.5 * (s**3 - s**2))
        for off, w in zip((-1, 0, 1, 2), ws):
            Wt[row, min(max(i + off, 0), n - 1)] += w
    return Wt


def _dare_residual(P, A, h, Q, r):
    """||Ric(P) - P||_F / (1 + ||P||_F), batched over leading axes (numpy)."""
    At = np.swapaxes(A, -1, -2)
    Ph = np.einsum("...ij,...j->...i", P, h)
    APh = np.einsum("...ij,...j->...i", A, Ph)
    S = np.einsum("...i,...i->...", h, Ph) + r
    nxt = A @ P @ At + Q - APh[..., :, None] * APh[..., None, :] / S[..., None, None]
    res = np.linalg.norm(nxt - P, axis=(-2, -1)) / (1.0 + np.linalg.norm(P, axis=(-2, -1)))
    return np.where(np.isfinite(res), res, np.inf)


def _newton(A, h, Q, Pinf, r, ar: R.Arith):
    """The filtering DARE by Newton's iteration (Hewer 1971), batched over r
    (Gc,) for one channel, in ``ar``: from the gain K = 0 (A is stable),
    each step solves P = (A - K h') P (A - K h')' + Q + r K K' exactly and
    takes the gain of that P, until P stops moving."""
    dt = ar.dtype
    A, h, Q = (np.asarray(x, dt) for x in (A, h, Q))
    r = np.asarray(r, dt)
    P = np.broadcast_to(np.asarray(Pinf, dt), r.shape + A.shape).copy()
    eps = np.finfo(dt).eps
    for _ in range(NEWTON_STEPS):
        Ph = ar.mv(P, h)
        K = ar.mv(A, Ph) / (Ph @ h + r)[:, None]
        Acl = A - K[:, :, None] * h[None, None, :]
        nxt = _lyap(Acl, Q + r[:, None, None] * K[:, :, None] * K[:, None, :], dt)
        nxt = 0.5 * (nxt + np.swapaxes(nxt, -1, -2))
        done = np.all(np.abs(nxt - P) <= 8 * eps * np.abs(nxt).max(axis=(-1, -2), keepdims=True))
        P = nxt
        if done:
            break
    return P


def _dare(A, h, Q, Pinf, r, ar: R.Arith):
    """Coarse DARE solutions (Gc, n, n) of one channel; NaN where the solver
    failed."""
    if _sla is None or ar.name != "float64":
        return _newton(A, h, Q, Pinf, r, ar).astype(np.float64)
    out = np.full((len(r),) + A.shape, np.nan)
    for j, rj in enumerate(r):
        try:
            out[j] = _sla.solve_discrete_are(A.T, h[:, None], Q, np.array([[rj]]))
        except (np.linalg.LinAlgError, ValueError):
            pass
    return out


def _nearest(good):
    """(Gc,) index of the nearest True of ``good`` (Gc,), ties to the lower."""
    idx = np.flatnonzero(good)
    if not len(idx):
        return np.zeros(len(good), int)
    gi = np.arange(len(good))
    return idx[np.argmin(np.abs(gi[:, None] - idx[None, :]), axis=1)]


def _lyap(G, QQ, dtype):
    """X = G X G' + QQ exactly, by the Kronecker form; (Gc, n, n)."""
    n = G.shape[-1]
    K = np.einsum("gij,gkl->gikjl", G, G).reshape(-1, n * n, n * n)
    x = np.linalg.solve(np.eye(n * n, dtype=dtype) - K, QQ.reshape(-1, n * n, 1).astype(dtype))
    return x.reshape(-1, n, n)


def bank(ssm: R.SSM, grid: Grid, ar: R.Arith = R.F64) -> Bank:
    """The steady-state tables of one file's model (``ssm`` of one file,
    float64), computed in ``ar``'s precision."""
    an = ar.like("numpy")
    dt = an.dtype
    A, Q, Pinf, H, pad = (x[0].cpu().numpy().astype(np.float64)
                          for x in (ssm.A, ssm.Q, ssm.Pinf, ssm.H, ssm.pad))
    C, bs = H.shape
    log_rc = np.linspace(grid.lo, grid.hi, grid.coarse)
    log_rf = np.linspace(grid.lo, grid.hi, grid.fine)
    rc = (10.0**log_rc).astype(dt)
    Wi = catmull_rom(log_rc, log_rf).astype(dt)
    Gf = grid.fine
    Ph = np.zeros((C, Gf, bs), dt)
    hPph, hPSh = np.zeros((C, Gf), dt), np.zeros((C, Gf), dt)
    Gn = np.zeros((C, Gf, bs, bs), dt)
    res_all = np.zeros((C, grid.coarse))
    ok_all = np.zeros((C, grid.coarse), bool)
    for c in range(C):
        n = int(round(bs - pad[c].sum()))
        # balanced to unit prior variances (a similarity: the tables come back
        # in the model's coordinates); a slow channel's derivative states have
        # prior variances 1e9 below its value's
        sc = np.sqrt(np.diag(Pinf[c, :n, :n]))
        Ac = A[c, :n, :n] * sc[None, :] / sc[:, None]
        Qc, Pic = (X[c, :n, :n] / np.outer(sc, sc) for X in (Q, Pinf))
        hc = H[c, :n] * sc
        Acd, Qcd, Picd, hcd = (x.astype(dt) for x in (Ac, Qc, Pic, hc))
        P = _dare(Ac, hc, Qc, Pic, rc.astype(np.float64), an)
        res = _dare_residual(P, Ac, hc, Qc, rc.astype(np.float64))
        good = np.isfinite(res) & (res < DARE_TOL)
        res_all[c], ok_all[c] = res, good
        hPinfh = hc @ Pic @ hc
        if not good.any():
            Ph[c], hPph[c] = 0.0, max(hPinfh, VAR_FLOOR)
            hPSh[c] = max(hPinfh, VAR_FLOOR)
            continue
        P = P[_nearest(good)].astype(dt)
        # forward tables: the solution interpolated, then its column and marginal
        Pi = np.einsum("gk,kij->gij", Wi, P)
        Pi = 0.5 * (Pi + np.swapaxes(Pi, -1, -2))
        Pih = an.mv(Pi, hcd)
        Ph[c, :, :n] = Pih * sc.astype(dt)
        hPph[c] = np.maximum(Pih @ hcd, VAR_FLOOR)
        # smoother tables at the coarse points
        Pc_h = an.mv(P, hcd)
        K = Pc_h / (Pc_h @ hcd + rc)[:, None]
        Pf = P - rc[:, None, None] * K[:, :, None] * K[:, None, :]
        APAQ = an.mm(an.mm(Acd, Pf), Acd.T) + Qcd
        APAQ = 0.5 * (APAQ + np.swapaxes(APAQ, -1, -2))
        PfA = an.mm(Pf, Acd.T)
        G = np.swapaxes(np.linalg.solve(np.swapaxes(APAQ, -1, -2), np.swapaxes(PfA, -1, -2)),
                        -1, -2)
        QQ = Pf - an.mm(an.mm(G, P), np.swapaxes(G, -1, -2))
        QQ = 0.5 * (QQ + np.swapaxes(QQ, -1, -2))
        finite = np.isfinite(QQ).all(axis=(-1, -2)) & np.isfinite(G).all(axis=(-1, -2))
        lam, V = np.linalg.eigh(np.where(finite[:, None, None], QQ, 0.0))
        QQ = np.einsum("gij,gj,gkj->gik", V, np.maximum(lam, 0.0), V)
        rho = np.abs(np.linalg.eigvals(np.where(finite[:, None, None], G, 0.0))).max(-1)
        PS = _lyap(G, QQ, dt)
        res_s = np.abs(an.mm(an.mm(G, PS), np.swapaxes(G, -1, -2)) - PS + QQ).max(
            axis=(-1, -2)) / (1.0 + np.abs(PS).max(axis=(-1, -2)))
        good_s = finite & (rho < 1.0) & np.isfinite(res_s) & (res_s < LYAP_TOL)
        if good_s.any():
            src = _nearest(good_s)
            G, PS = G[src], PS[src]
        else:
            G, PS = np.zeros_like(G), np.broadcast_to(Picd, PS.shape)
        Gn[c, :, :n, :n] = np.einsum("gk,kij->gij", Wi, G) * (sc[:, None] / sc[None, :]).astype(dt)
        PSf = np.einsum("gk,kij->gij", Wi, PS)
        PSf = 0.5 * (PSf + np.swapaxes(PSf, -1, -2))
        hPSh[c] = np.maximum(an.mv(PSf, hcd) @ hcd, VAR_FLOOR)
    return Bank(log_r=log_rf, Ph=Ph, hPph=hPph, Gn=Gn, hPSh=hPSh, dare_res=res_all,
                dare_ok=ok_all)


def lookup(r_fine: np.ndarray, tt: np.ndarray) -> np.ndarray:
    """Index of the grid point nearest in linear r to R = 1/tt, ties to the
    lower; the top of the grid where tt <= 0."""
    pos = tt > 0
    Rn = np.where(pos, 1.0 / np.where(pos, tt, 1.0), np.inf).astype(r_fine.dtype)
    j = np.clip(np.searchsorted(r_fine, Rn), 1, len(r_fine) - 1)
    lower = np.abs(Rn - r_fine[j - 1]) <= np.abs(r_fine[j] - Rn)
    return np.where(pos, np.where(lower, j - 1, j), len(r_fine) - 1)


# ---------------------------------------------------------------------------
# The steady passes
# ---------------------------------------------------------------------------


def steady_filter(mats, bk: Bank, lik: R.Lik, Wt, sn2, y, obs, match, tt_in, tn_in,
                  damp: float):
    """One forward pass in ``lik.ar`` (numpy): sites ``tt_in``, ``tn_in``
    (T, C) held where ``match`` is False, matched again where it is True
    and the step is observed.  mats: (A, Pinf (C, bs, bs), H (C, bs)).
    Returns filtered means (T, C, bs), the step's table index (T, C), lZ
    (T,) and the sites (T, C)."""
    ar = lik.ar
    A, Pinf, H = mats
    T, (C, bs) = len(y), H.shape
    r_fine = (10.0**bk.log_r).astype(ar.dtype)
    car = np.arange(C)
    tab = np.concatenate([bk.Ph, bk.hPph[..., None]], -1).astype(ar.dtype)
    do = obs & match
    tt_eff = np.where(obs[:, None], tt_in, 0.0)
    idx = lookup(r_fine, tt_eff)
    idx_next = np.where(obs[:, None], idx, lookup(r_fine, tt_in))
    tt, tn = tt_in.copy(), tn_in.copy()
    lZ = np.zeros(T, ar.dtype)
    ms = np.empty((T, C, bs), ar.dtype)
    m = np.zeros((C, bs), ar.dtype)
    row = np.concatenate([ar.mv(Pinf, H), (H * ar.mv(Pinf, H)).sum(-1)[:, None]], -1)
    for k in range(T):
        Ph_prev, varp = row[:, :bs], row[:, bs]
        m = ar.mv(A, m)
        fmu = (H * m).sum(-1)
        if do[k]:
            lz, dl, d2 = lik.moments(y[k:k + 1], fmu[None], varp[None], Wt, sn2)
            denom = 1.0 + d2[0] * varp
            tt[k] = np.maximum((1.0 - damp) * tt_in[k] + damp * (-d2[0] / denom), 0.0)
            tn[k] = (1.0 - damp) * tn_in[k] + damp * ((dl[0] - fmu * d2[0]) / denom)
            lZ[k] = lz[0]
            idx[k] = idx_next[k] = lookup(r_fine, tt[k])
        te = tt[k] if obs[k] else np.zeros_like(tt[k])
        gain = np.where(te > 0.0, (tn[k] - te * fmu) / (te * varp + 1.0), 0.0)
        m = m + Ph_prev * gain[:, None]
        ms[k] = m
        row = tab[car, idx_next[k]]
    return ms, idx, lZ, tt, tn


def steady_smoother(A, bk: Bank, ms, idx, ar: R.Arith):
    """ms_k = G_k ms_{k+1} + mf_k - G_k A mf_k backwards from the last
    filtered mean; (T, C, bs) in ``ar`` (numpy)."""
    T, C, _ = ms.shape
    G = bk.Gn.astype(ar.dtype)[np.arange(C), idx]  # (T, C, bs, bs)
    c = ms - ar.mv(G, ar.mv(A, ms))
    out = np.empty_like(ms)
    m = out[-1] = ms[-1]
    for k in range(T - 2, -1, -1):
        m = ar.mv(G[k], m) + c[k]
        out[k] = m
    return out


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------


def ihgp(w: dict, model: dict, y, obs, *, ep_itts: int, ep_fraction: float, damping,
         grid: Grid, ar: R.Arith = R.F64, device="cpu"):
    """Infinite-horizon Power EP on one signal: y, obs (T,) numpy (obs
    bool).  The passes run in numpy on the host, the re-sites in torch on
    ``device``.  Returns Eft, Varft (T, C) and nlZ (ep_itts,) as float64
    torch tensors on the CPU, the last pass's table index (T, C) and the
    bank."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    damp = lambda i: damping[min(i, len(damping) - 1)]
    dev = torch.device(device)
    D, N = len(w["sub_var"]), len(w["mod_var"])
    link, variant = model.get("link", "softplus"), model["variant"]
    ssm = R.SSM([w], model["kernel1"], model["kernel2"], R.F64, "cpu")
    bk = bank(ssm, grid, ar)
    an = ar.like("numpy")
    A, Pinf, H = (x[0].numpy().astype(an.dtype) for x in (ssm.A, ssm.Pinf, ssm.H))
    lik_np = R.Lik(D, N, link, variant, an)
    lik = R.Lik(D, N, link, variant, ar, dev)
    Wt_np = np.asarray(w["W"], np.float64).T[None]
    sn2_np = np.array([float(w["lik"])])
    obs = np.asarray(obs, bool)
    T = len(obs)
    y0 = np.where(obs, np.asarray(y, np.float64), 0.0)
    yn = y0.astype(an.dtype)
    C = H.shape[0]
    tt = np.zeros((T, C), an.dtype)
    tn = np.zeros((T, C), an.dtype)
    hPSh = bk.hPSh.astype(an.dtype)
    car = np.arange(C)
    last = np.zeros(T, bool)
    last[-1] = True
    obs_resite = obs & ~last
    chunk = max(1, RESITE_ELEMS // (lik.S * (D + N)))
    Wt, sn2 = ar.array(Wt_np, dev), ar.array(sn2_np, dev)
    yT = ar.array(y0[:, None], dev)
    oT = torch.as_tensor(obs_resite[:, None], device=dev)
    nlZ, lZ_last = [], 0.0
    for itt in range(ep_itts):
        match = np.ones(T, bool) if itt == 0 else last
        ms, idx, lZ, tt, tn = steady_filter((A, Pinf, H), bk, lik_np, an.array(Wt_np),
                                            an.array(sn2_np), yn, obs, match, tt, tn, damp(itt))
        if itt == 0:
            nlZ.append(-lZ.astype(np.float64).sum())
        lZ_last = lZ[-1]
        sm = steady_smoother(A, bk, ms, idx, an)
        mu, var = (H * sm).sum(-1), hPSh[car, idx]
        if itt < ep_itts - 1:
            t3 = lambda x: ar.array(x[:, None], dev)
            (tt_new, tn_new), lz = R.resite(lik, Wt, sn2, yT, oT, t3(mu), t3(var), t3(tt),
                                           t3(tn), ep_fraction, damp(itt + 1), chunk)
            tt = tt_new[:, 0].cpu().numpy().astype(an.dtype)
            tn = tn_new[:, 0].cpu().numpy().astype(an.dtype)
            lz = lz[:, 0].cpu().numpy().astype(np.float64)
            lz[-1] = lZ_last
            nlZ.append(-lz.sum())
    f64 = lambda x: torch.as_tensor(np.asarray(x, np.float64))
    return f64(mu), f64(var), f64(nlZ), idx, bk
