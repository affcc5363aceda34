"""Fused filter / smoother / ADF passes: CUDA kernels and their plain twins.

Port of ``nsgp_tpu/ops/pallas_kalman.py``.  Four kernels, each a whole
sequential pass over T in one launch (``csrc/fused_kalman.cu``,
``csrc/fused_adf.cuh``, ``csrc/fused_adf_mb.cuh``; K3 and K4 share their step,
``csrc/adf_step.cuh``):

    fused_fwd     (K1)  forward filter with fixed sites    <- _fwd_kernel
    fused_bwd     (K2)  RTS smoother with a Cholesky gain  <- _bwd_kernel
    fused_adf     (K3)  EP sweep 1: filter + in-step ADF   <- _adf_kernel
    fused_adf_mb  (K4)  K3 over BF files, a cluster of     <- _adf_kernel_mb
                        CTAs a file, sigma points streamed

Each wrapper does exactly one of two things: on CPU tensors it runs its
plain PyTorch version (``*_plain``, same step order: predict from (0, Pinf)
at step 0 with no first-step skip, no symmetrisation, the Cholesky gain,
sqrt(max(a, 1e-12)) for 'sq'); on CUDA tensors it launches the kernel or
raises.  There is no fallback between the two.  Each wrapper counts its
kernel launches in ``<wrapper>.launches``.

Trajectories are C-major, (T, C, bs) / (T, C, bs, bs), exactly T steps: the
TPU kernels' b-major (Tp*bs, C) rows and the padding of T to a block exist
only for TPU tiles.  K4's carry a file axis, (T, BF, C, ...), which viewed as
(T, BF*C, ...) is what K1 and K2 take: they run any number of channels.  The
kernels assume the stationary discretization Q = Pinf - A Pinf A' (the
``build_modulator_ssm`` default), under which one prediction from (0, Pinf)
is exactly (0, Pinf); the pass-level entry points check it once per call.
"""

from __future__ import annotations

import ctypes
import math

import torch

from nsgp_tpu_torch.ops.kalman import Sites
from nsgp_tpu_torch.ops.moments import LINKS, MomentParams, sigma_points
from nsgp_tpu_torch.ops.ssm import BlockSSM

MAX_BLOCK = 8  # block sizes instantiated in csrc/*.cu
_LOG2PI = math.log(2.0 * math.pi)
_LAUNCH_CODES = {  # what csrc/adf_step.cuh:launch_adf_sweep returns besides CUDA errors
    -1: "unsupported block size or dtype",
    -2: "a width the thread mapping cannot take",
    -3: "the thread-block cluster cannot be resident on this card",
}


# ---------------------------------------------------------------------------
# Plain PyTorch versions (CPU path; reference for the kernels on the card)
# ---------------------------------------------------------------------------


def _predict(A, At, Q, m, P):
    return (A @ m[..., None])[..., 0], A @ P @ At + Q


def _observe(H, mp, Pp):
    fmu = (H * mp).sum(-1)
    PH = (Pp @ H[..., None])[..., 0]
    return fmu, PH, (H * PH).sum(-1)


def _update(tt, tn, fmu, HPH, PH, mp, Pp):
    z = tt * HPH + 1.0
    v = (tt * fmu - tn) / z
    w = tt / z
    m = mp - PH * v[..., None]
    P = Pp - w[..., None, None] * PH[..., :, None] * PH[..., None, :]
    return m, P


def fused_fwd_plain(ttau, tnu, A, Q, Pinf, H):
    """K1 reference.  ttau/tnu (T, C); A, Q, Pinf (C, bs, bs); H (C, bs).
    Returns filtered ms (T, C, bs), Ps (T, C, bs, bs)."""
    T, C = ttau.shape
    bs = H.shape[1]
    At = A.transpose(-1, -2)
    m = torch.zeros((C, bs), dtype=A.dtype, device=A.device)
    P = Pinf
    ms = torch.empty((T, C, bs), dtype=A.dtype, device=A.device)
    Ps = torch.empty((T, C, bs, bs), dtype=A.dtype, device=A.device)
    for t in range(T):
        mp, Pp = _predict(A, At, Q, m, P)
        fmu, PH, HPH = _observe(H, mp, Pp)
        m, P = _update(ttau[t], tnu[t], fmu, HPH, PH, mp, Pp)
        ms[t] = m
        Ps[t] = P
    return ms, Ps


def _chol_gain(M, AP, eps=1e-30):
    """G with G' = M^{-1} AP by an unrolled Cholesky of M (pivot floor eps),
    elementwise over the leading axes — the kernel's arithmetic, vectorised."""
    bs = M.shape[-1]
    L = [[None] * bs for _ in range(bs)]
    inv_d = [None] * bs
    for j in range(bs):
        s = M[..., j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        d = torch.sqrt(torch.clamp_min(s, eps))
        L[j][j] = d
        inv_d[j] = 1.0 / d
        for i in range(j + 1, bs):
            s = M[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv_d[j]
    # forward / back substitution on all columns of AP at once (rows i)
    y = [None] * bs
    for i in range(bs):
        s = AP[..., i, :]
        for k in range(i):
            s = s - L[i][k][..., None] * y[k]
        y[i] = s * inv_d[i][..., None]
    x = [None] * bs
    for i in reversed(range(bs)):
        s = y[i]
        for k in range(i + 1, bs):
            s = s - L[k][i][..., None] * x[k]
        x[i] = s * inv_d[i][..., None]
    return torch.stack(x, dim=-1)  # (..., l, i) = G[l][i]


def fused_bwd_plain(ms, Ps, A, Q, pad):
    """K2 reference.  ms (T, C, bs), Ps (T, C, bs, bs) filtered; A, Q
    (C, bs, bs); pad (C, bs) = 1 on zero-padded dims.  Returns smoothed
    (T, C, bs), (T, C, bs, bs).  The gains depend only on the filtered P_k,
    so they are formed for all steps at once; the loop is the affine
    recursion."""
    T = ms.shape[0]
    At = A.transpose(-1, -2)
    Am = (A @ ms[..., None])[..., 0]
    AP = A @ Ps
    Pp = AP @ At + Q
    G = _chol_gain(Pp + torch.diag_embed(pad), AP)
    Gt = G.transpose(-1, -2)
    sm = torch.empty_like(ms)
    sP = torch.empty_like(Ps)
    mn, Pn = Am[T - 1], Pp[T - 1]  # last step: smoothed == filtered
    for t in range(T - 1, -1, -1):
        mn = ms[t] + (G[t] @ (mn - Am[t])[..., None])[..., 0]
        Pn = Ps[t] + G[t] @ (Pn - Pp[t]) @ Gt[t]
        sm[t] = mn
        sP[t] = Pn
    return sm, sP


def fused_adf_plain(y, obs, A, Q, Pinf, H, W, xi, wn, sn2, *, damp, link, variant,
                    z_floor):
    """K3 reference: ADF forward sweep from zero sites.

    y, obs (T,) (obs 0/1); A, Q, Pinf (C, bs, bs); H (C, bs); W (D, N);
    xi (S, N), wn (S,) unit sigma points; sn2 () noise variance.  Returns
    ms (T, C, bs), Ps (T, C, bs, bs), lZ (T,), ttau, tnu (T, C).
    """
    T = y.shape[0]
    C, bs = H.shape
    D = W.shape[0]
    dt_, dev = A.dtype, A.device
    lk_fn = LINKS[link]
    At = A.transpose(-1, -2)
    Wt = W.T
    tiny = torch.finfo(dt_).tiny
    log_floor = float(torch.log(torch.tensor(z_floor, dtype=dt_)))
    observed = obs > 0
    m = torch.zeros((C, bs), dtype=dt_, device=dev)
    P = Pinf
    ms = torch.empty((T, C, bs), dtype=dt_, device=dev)
    Ps = torch.empty((T, C, bs, bs), dtype=dt_, device=dev)
    lZ = torch.empty((T,), dtype=dt_, device=dev)
    tts = torch.empty((T, C), dtype=dt_, device=dev)
    tns = torch.empty((T, C), dtype=dt_, device=dev)
    for t in range(T):
        mp, Pp = _predict(A, At, Q, m, P)
        fmu, PH, HPH = _observe(H, mp, Pp)
        # ---- cubature moments at the predicted marginal ------------------
        mu_z, mu_g = fmu[:D], fmu[D:]
        s2_z, s2_g = HPH[:D], HPH[D:]
        xn = mu_g + torch.sqrt(torch.clamp_min(s2_g, 0.0)) * xi  # (S, N)
        a = lk_fn(xn) @ Wt  # (S, D)
        if variant == "sq":
            a = torch.sqrt(torch.clamp_min(a, 1e-12))
        s2e = sn2 + (a * a * s2_z).sum(1)  # (S,)
        resid = y[t] - (a * mu_z).sum(1)
        log_norm = -0.5 * (resid * resid / s2e + torch.log(s2e) + _LOG2PI)
        lmax = log_norm.max()
        lmax = torch.where(torch.isfinite(lmax), lmax, torch.zeros_like(lmax))
        wns = wn * torch.exp(log_norm - lmax)
        # raw-scale Z floor (likModulatorNMFPower.m:55), folded into Zi
        Z0 = torch.clamp_min(wns.sum(), tiny)
        lZ_raw = lmax + torch.log(Z0)
        lZk = torch.clamp_min(lZ_raw, log_floor)
        Zi = torch.exp(lZ_raw - lZk) / Z0
        rs = resid / s2e
        dlZ_z = Zi * ((wns * rs)[:, None] * a).sum(0)
        dmu_g = (xn - mu_g) / s2_g
        dlZ_g = Zi * (wns[:, None] * dmu_g).sum(0)
        d2_z = Zi * (wns[:, None] * (a * a) * (rs * rs - 1.0 / s2e)[:, None]).sum(0) \
            - dlZ_z * dlZ_z
        d2_g = Zi * (wns[:, None] * (dmu_g * dmu_g - 1.0 / s2_g)).sum(0) - dlZ_g * dlZ_g
        dlZ = torch.cat([dlZ_z, dlZ_g])
        d2lZ = torch.cat([d2_z, d2_g])
        # ---- damped ADF site update from zero incoming sites --------------
        denom = 1.0 + d2lZ * HPH
        tt = torch.clamp_min(damp * (-d2lZ / denom), 0.0)
        tn = damp * ((dlZ - fmu * d2lZ) / denom)
        # unobserved steps: zero sites (a no-op update) and lZ = 0
        tt = torch.where(observed[t], tt, torch.zeros_like(tt))
        tn = torch.where(observed[t], tn, torch.zeros_like(tn))
        lZ[t] = torch.where(observed[t], lZk, torch.zeros_like(lZk))
        tts[t] = tt
        tns[t] = tn
        m, P = _update(tt, tn, fmu, HPH, PH, mp, Pp)
        ms[t] = m
        Ps[t] = P
    return ms, Ps, lZ, tts, tns


def fused_adf_mb_plain(y, obs, A, Q, Pinf, H, W, xi, wn, sn2, *, damp, link, variant,
                       z_floor, s_chunk=0):
    """K4 reference: ADF forward sweep from zero sites over BF files at once.

    y, obs (T, BF) (obs 0/1); A, Q, Pinf (BF, C, bs, bs); H (BF, C, bs);
    W (BF, D, N); xi (S, N), wn (S,) shared unit sigma points; sn2 (BF,).
    Returns ms (T, BF, C, bs), Ps (T, BF, C, bs, bs), lZ (T, BF), ttau, tnu
    (T, BF, C).

    The sigma points are taken ``s_chunk`` at a time (0 = all S in one chunk)
    with the online max-rescale of ``_adf_kernel_mb``: per chunk the chunk max
    ``mc`` (0 where not finite), ``m_new = max(m_run, mc)``, the chunk's sums
    at shift ``m_new``, and the totals so far rescaled by exp(m_run - m_new)
    (the first chunk is not rescaled).  Per file the result equals
    ``fused_adf_plain`` up to that reordering.
    """
    T, BF = y.shape
    _, C, bs = H.shape
    D = W.shape[1]
    S = wn.shape[0]
    sc = s_chunk if s_chunk else S
    dt_, dev = A.dtype, A.device
    lk_fn = LINKS[link]
    At = A.transpose(-1, -2)
    Wt = W.transpose(-1, -2)  # (BF, N, D)
    tiny = torch.finfo(dt_).tiny
    log_floor = float(torch.log(torch.tensor(z_floor, dtype=dt_)))
    observed = obs > 0
    m = torch.zeros((BF, C, bs), dtype=dt_, device=dev)
    P = Pinf
    ms = torch.empty((T, BF, C, bs), dtype=dt_, device=dev)
    Ps = torch.empty((T, BF, C, bs, bs), dtype=dt_, device=dev)
    lZ = torch.empty((T, BF), dtype=dt_, device=dev)
    tts = torch.empty((T, BF, C), dtype=dt_, device=dev)
    tns = torch.empty((T, BF, C), dtype=dt_, device=dev)
    for t in range(T):
        mp, Pp = _predict(A, At, Q, m, P)
        fmu, PH, HPH = _observe(H, mp, Pp)  # (BF, C)
        mu_z, mu_g = fmu[:, None, :D], fmu[:, None, D:]  # (BF, 1, .)
        s2_z, s2_g = HPH[:, None, :D], HPH[:, None, D:]
        sd_g = torch.sqrt(torch.clamp_min(s2_g, 0.0))
        m_run = tot = None
        for c0 in range(0, S, sc):
            xn = mu_g + sd_g * xi[c0:c0 + sc]  # (BF, sc, N)
            a = lk_fn(xn) @ Wt  # (BF, sc, D)
            if variant == "sq":
                a = torch.sqrt(torch.clamp_min(a, 1e-12))
            s2e = sn2[:, None] + (a * a * s2_z).sum(-1)  # (BF, sc)
            resid = y[t][:, None] - (a * mu_z).sum(-1)
            log_norm = -0.5 * (resid * resid / s2e + torch.log(s2e) + _LOG2PI)
            mc = log_norm.amax(dim=1)
            mc = torch.where(torch.isfinite(mc), mc, torch.zeros_like(mc))
            m_new = mc if m_run is None else torch.maximum(m_run, mc)
            wns = wn[c0:c0 + sc] * torch.exp(log_norm - m_new[:, None])
            rs = resid / s2e
            dmu_g = (xn - mu_g) / s2_g
            part = (  # Z (BF,), A1, A2 (BF, D), G1, G2 (BF, N)
                wns.sum(1),
                ((wns * rs)[..., None] * a).sum(1),
                (wns[..., None] * (a * a) * (rs * rs - 1.0 / s2e)[..., None]).sum(1),
                (wns[..., None] * dmu_g).sum(1),
                (wns[..., None] * (dmu_g * dmu_g - 1.0 / s2_g)).sum(1),
            )
            if tot is None:
                tot = part
            else:
                al = torch.exp(m_run - m_new)
                tot = tuple(x * al.reshape((BF,) + (1,) * (x.dim() - 1)) + xc
                            for x, xc in zip(tot, part))
            m_run = m_new
        Z, A1, A2, G1, G2 = tot
        # raw-scale Z floor (likModulatorNMFPower.m:55), folded into Zi
        Z0 = torch.clamp_min(Z, tiny)
        lZ_raw = m_run + torch.log(Z0)
        lZk = torch.clamp_min(lZ_raw, log_floor)
        Zi = (torch.exp(lZ_raw - lZk) / Z0)[:, None]
        dlZ_z, dlZ_g = Zi * A1, Zi * G1
        dlZ = torch.cat([dlZ_z, dlZ_g], dim=1)
        d2lZ = torch.cat([Zi * A2 - dlZ_z * dlZ_z, Zi * G2 - dlZ_g * dlZ_g], dim=1)
        # ---- damped ADF site update from zero incoming sites --------------
        denom = 1.0 + d2lZ * HPH
        tt = torch.clamp_min(damp * (-d2lZ / denom), 0.0)
        tn = damp * ((dlZ - fmu * d2lZ) / denom)
        # unobserved steps: zero sites (a no-op update) and lZ = 0
        seen = observed[t][:, None]
        tt = torch.where(seen, tt, torch.zeros_like(tt))
        tn = torch.where(seen, tn, torch.zeros_like(tn))
        lZ[t] = torch.where(observed[t], lZk, torch.zeros_like(lZk))
        tts[t] = tt
        tns[t] = tn
        m, P = _update(tt, tn, fmu, HPH, PH, mp, Pp)
        ms[t] = m
        Ps[t] = P
    return ms, Ps, lZ, tts, tns


def shifted_partial(log_norm, wn, terms):
    """What one lane (or any partition of the sigma points) holds after its
    points, as ``csrc/adf_step.cuh`` keeps it: the partition's own shift and
    its K totals at that shift.

    log_norm, wn (P,), terms (P, K) -> (shift (), totals (K,)).  The shift is
    the largest log-normaliser under the kernel's plain ``>`` (a NaN never
    wins: it poisons the totals instead); an empty partition has shift -inf
    and zero totals; a point at -inf adds exactly zero.
    """
    neg_inf = torch.full((), -math.inf, dtype=terms.dtype, device=terms.device)
    if log_norm.numel() == 0:
        return neg_inf, torch.zeros(terms.shape[1:], dtype=terms.dtype, device=terms.device)
    shift = torch.where(torch.isnan(log_norm), neg_inf, log_norm).amax()
    e = torch.where(log_norm == -math.inf, torch.zeros_like(log_norm),
                    torch.exp(log_norm - shift))
    return shift, ((wn * e)[:, None] * terms).sum(0)


def merge_shifted_partials(shifts, totals):
    """The kernels' merge of partial totals kept under different shifts
    (``merge_partials`` in ``csrc/adf_step.cuh``): shifts (P,), totals (P, K)
    -> (shift (), totals (K,)) with

        m = max_p shifts[p],   out = sum_p totals[p] * scale_p   (in order p),
        scale_p = 0 where shifts[p] = -inf (an empty partial, whatever m is),
                  exp(shifts[p] - m) otherwise.

    Totals are signed (cubature weights may be negative): they are rescaled,
    never logged.  The returned shift is m, or 0 where m is not finite (the
    rule applied once, to the merged shift); every consumer forms ratios
    ``out[k] / out[0]`` and ``shift + log(out[0])``, in which m cancels.
    """
    m = shifts.amax()
    scale = torch.where(shifts == -math.inf, torch.zeros_like(shifts), torch.exp(shifts - m))
    out = torch.zeros_like(totals[0])
    for p in range(totals.shape[0]):
        out = out + totals[p] * scale[p]
    return torch.where(torch.isfinite(m), m, torch.zeros_like(m)), out


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _on_cpu(*xs) -> bool:
    """True for CPU tensors; False for CUDA tensors; raises otherwise."""
    devs = {x.device for x in xs}
    if len(devs) != 1:
        raise ValueError(f"fused kernels need all tensors on one device, got {devs}")
    dev = devs.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"fused kernels run on CPU (plain) or CUDA tensors, not {dev}")
    dtypes = {x.dtype for x in xs}
    if len(dtypes) != 1 or dtypes.pop() not in (torch.float32, torch.float64):
        raise TypeError(f"fused kernels need one dtype, float32 or float64; got {dtypes}")
    return False


def _ptr(x: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(x.data_ptr())


def _launch(name: str, fn, *args, device) -> None:
    """Call a C entry point on the current stream of ``device``; raise on
    any CUDA error it reports."""
    with torch.cuda.device(device):
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        rc = fn(*args, stream)
    if rc != 0:
        why = _LAUNCH_CODES.get(rc, "CUDA error")
        raise RuntimeError(f"{name}: kernel launch failed (code {rc}: {why})")


def _check_shapes(name: str, bs: int, T: int, **expected) -> None:
    """The kernels index raw pointers: refuse a block size they do not
    instantiate, an empty signal, or any tensor whose shape disagrees."""
    if not 1 <= bs <= MAX_BLOCK:
        raise ValueError(f"fused kernels support block sizes 1..{MAX_BLOCK}, got {bs}")
    if T < 1:
        raise ValueError(f"{name} needs T >= 1")
    for arg, (x, shape) in expected.items():
        if tuple(x.shape) != shape:
            raise ValueError(f"{name}: {arg} has shape {tuple(x.shape)}, expected {shape}")


def fused_fwd(ttau, tnu, A, Q, Pinf, H):
    """K1: forward filter with fixed sites (see ``fused_fwd_plain``)."""
    if _on_cpu(ttau, tnu, A, Q, Pinf, H):
        return fused_fwd_plain(ttau, tnu, A, Q, Pinf, H)
    from nsgp_tpu_torch.ops import _build

    T, C = ttau.shape
    bs = H.shape[1]
    mat = (C, bs, bs)
    _check_shapes("fused_fwd", bs, T, tnu=(tnu, (T, C)), A=(A, mat), Q=(Q, mat),
                  Pinf=(Pinf, mat), H=(H, (C, bs)))
    args = [x.contiguous() for x in (ttau, tnu, A, Q, Pinf, H)]
    ms = torch.empty((T, C, bs), dtype=A.dtype, device=A.device)
    Ps = torch.empty((T, C, bs, bs), dtype=A.dtype, device=A.device)
    lib = _build.library()
    _launch("fused_fwd", lib.nsgp_fused_fwd, int(A.dtype == torch.float64), bs,
            *map(_ptr, args), _ptr(ms), _ptr(Ps), T, C, device=A.device)
    fused_fwd.launches += 1
    return ms, Ps


def fused_bwd(ms, Ps, A, Q, pad):
    """K2: RTS smoother over a filtered trajectory (see ``fused_bwd_plain``)."""
    if _on_cpu(ms, Ps, A, Q, pad):
        return fused_bwd_plain(ms, Ps, A, Q, pad)
    from nsgp_tpu_torch.ops import _build

    T, C, bs = ms.shape
    mat = (C, bs, bs)
    _check_shapes("fused_bwd", bs, T, Ps=(Ps, (T, C, bs, bs)), A=(A, mat), Q=(Q, mat),
                  pad=(pad, (C, bs)))
    args = [x.contiguous() for x in (ms, Ps, A, Q, pad)]
    sm = torch.empty_like(args[0])
    sP = torch.empty_like(args[1])
    lib = _build.library()
    _launch("fused_bwd", lib.nsgp_fused_bwd, int(A.dtype == torch.float64), bs,
            *map(_ptr, args), _ptr(sm), _ptr(sP), T, C, device=A.device)
    fused_bwd.launches += 1
    return sm, sP


def _check_adf(name: str, lib, C: int, D: int, N: int, S: int, link, variant):
    """What both ADF kernels refuse: an unknown link, a channel count that
    is not D + N, more subbands or modulators than a warp's lanes can take
    (within that width a channel a thread and the shared layout always fit)."""
    if link not in LINKS or variant not in ("amp", "sq"):
        raise ValueError(f"unsupported link/variant {link!r}/{variant!r}")
    if C != D + N:
        raise ValueError(f"{name} needs C = D + N channels, got C={C}, D={D}, N={N}")
    width = lib.nsgp_adf_max_width()
    if not (1 <= D <= width and 1 <= N <= width and S >= 1):
        raise ValueError(f"{name} takes at most {width} subbands and {width} modulators "
                         f"and needs a sigma point: D={D}, N={N}, S={S}")


def adf_launch_shape(S: int) -> dict:
    """How the ADF kernels launch for S sigma points: threads a CTA and CTAs
    a file (the cluster size).  Needs the built library."""
    from nsgp_tpu_torch.ops import _build

    lib = _build.library()
    return {"threads": lib.nsgp_adf_threads(), "cluster": lib.nsgp_adf_cluster(S)}


def fused_adf(y, obs, A, Q, Pinf, H, W, xi, wn, sn2, *, damp, link, variant, z_floor):
    """K3: ADF forward sweep with in-step cubature moments (see
    ``fused_adf_plain``)."""
    if _on_cpu(y, obs, A, Q, Pinf, H, W, xi, wn, sn2):
        return fused_adf_plain(y, obs, A, Q, Pinf, H, W, xi, wn, sn2, damp=damp,
                               link=link, variant=variant, z_floor=z_floor)
    from nsgp_tpu_torch.ops import _build

    T = y.shape[0]
    C, bs = H.shape
    D, N = W.shape
    S = wn.shape[0]
    mat = (C, bs, bs)
    _check_shapes("fused_adf", bs, T, y=(y, (T,)), obs=(obs, (T,)), A=(A, mat), Q=(Q, mat),
                  Pinf=(Pinf, mat), H=(H, (C, bs)), W=(W, (D, N)), xi=(xi, (S, N)),
                  wn=(wn, (S,)), sn2=(sn2.reshape(-1), (1,)))
    lib = _build.library()
    is_f64 = int(A.dtype == torch.float64)
    _check_adf("fused_adf", lib, C, D, N, S, link, variant)
    args = [x.contiguous() for x in (y, obs, A, Q, Pinf, H, W, xi, wn, sn2.reshape(1))]
    dt_, dev = A.dtype, A.device
    ms = torch.empty((T, C, bs), dtype=dt_, device=dev)
    Ps = torch.empty((T, C, bs, bs), dtype=dt_, device=dev)
    lZ = torch.empty((T,), dtype=dt_, device=dev)
    tt = torch.empty((T, C), dtype=dt_, device=dev)
    tn = torch.empty((T, C), dtype=dt_, device=dev)
    log_floor = float(torch.log(torch.tensor(z_floor, dtype=dt_)))
    _launch("fused_adf", lib.nsgp_fused_adf_f64 if is_f64 else lib.nsgp_fused_adf_f32, bs,
            *map(_ptr, args),
            float(damp), log_floor, T, D, N, S, int(link == "exp"), int(variant == "sq"),
            _ptr(ms), _ptr(Ps), _ptr(lZ), _ptr(tt), _ptr(tn), device=dev)
    fused_adf.launches += 1
    return ms, Ps, lZ, tt, tn


def fused_adf_mb(y, obs, A, Q, Pinf, H, W, xi, wn, sn2, *, damp, link, variant, z_floor,
                 s_chunk=0, _lib=None, _cycles=None):
    """K4: ADF forward sweep over BF files in one launch, a cluster of CTAs a
    file (see ``fused_adf_mb_plain``).  ``s_chunk`` keeps its meaning for the
    plain version (0 = one shift over all S, > 0 = streamed).  The kernel
    evaluates each point once in either mode: every lane keeps its totals
    under its own running shift and the partials are merged once per step
    (``merge_shifted_partials``), so on the card the value changes nothing.
    ``_lib`` / ``_cycles`` are for ``tools/probe_adf_cycles.py``: a library
    built with the clock probe and the six int64 it fills."""
    if _on_cpu(y, obs, A, Q, Pinf, H, W, xi, wn, sn2):
        return fused_adf_mb_plain(y, obs, A, Q, Pinf, H, W, xi, wn, sn2, damp=damp,
                                  link=link, variant=variant, z_floor=z_floor,
                                  s_chunk=s_chunk)
    from nsgp_tpu_torch.ops import _build

    T, BF = y.shape
    _, C, bs = H.shape
    _, D, N = W.shape
    S = wn.shape[0]
    mat = (BF, C, bs, bs)
    _check_shapes("fused_adf_mb", bs, T, obs=(obs, (T, BF)), A=(A, mat), Q=(Q, mat),
                  Pinf=(Pinf, mat), H=(H, (BF, C, bs)), W=(W, (BF, D, N)), xi=(xi, (S, N)),
                  wn=(wn, (S,)), sn2=(sn2, (BF,)))
    if BF < 1 or s_chunk < 0:
        raise ValueError(f"fused_adf_mb needs BF >= 1 and s_chunk >= 0, got {BF}, {s_chunk}")
    lib = _lib or _build.library()
    is_f64 = int(A.dtype == torch.float64)
    _check_adf("fused_adf_mb", lib, C, D, N, S, link, variant)
    args = [x.contiguous() for x in (y, obs, A, Q, Pinf, H, W, xi, wn, sn2)]
    dt_, dev = A.dtype, A.device
    ms = torch.empty((T, BF, C, bs), dtype=dt_, device=dev)
    Ps = torch.empty((T, BF, C, bs, bs), dtype=dt_, device=dev)
    lZ = torch.empty((T, BF), dtype=dt_, device=dev)
    tt = torch.empty((T, BF, C), dtype=dt_, device=dev)
    tn = torch.empty((T, BF, C), dtype=dt_, device=dev)
    log_floor = float(torch.log(torch.tensor(z_floor, dtype=dt_)))
    cycles = ctypes.c_void_p(None) if _cycles is None else _ptr(_cycles)
    _launch("fused_adf_mb", lib.nsgp_fused_adf_mb_f64 if is_f64 else lib.nsgp_fused_adf_mb_f32,
            bs, *map(_ptr, args),
            float(damp), log_floor, T, BF, D, N, S, int(link == "exp"),
            int(variant == "sq"), _ptr(ms), _ptr(Ps), _ptr(lZ), _ptr(tt), _ptr(tn), cycles,
            device=dev)
    fused_adf_mb.launches += 1
    return ms, Ps, lZ, tt, tn


WRAPPERS = (fused_fwd, fused_bwd, fused_adf, fused_adf_mb)


def reset_launches() -> None:
    for fn in WRAPPERS:
        fn.launches = 0


reset_launches()


# ---------------------------------------------------------------------------
# Pass-level entry points (counterparts of the pallas_kalman functions)
# ---------------------------------------------------------------------------


def _flat(ms, Ps):
    T = ms.shape[0]
    return ms.reshape(T, -1), Ps.reshape(T, -1)


def check_stationary(ssm: BlockSSM) -> None:
    """Raise unless Q = Pinf - A Pinf A' (any leading axes): the kernels
    start from (0, Pinf) and rely on one prediction leaving it unchanged.
    Tolerance relative to max |Pinf|: 1e-5 in float32, 1e-10 in float64."""
    gap = ssm.Q - (ssm.Pinf - ssm.A @ ssm.Pinf @ ssm.A.transpose(-1, -2))
    tol = 1e-10 if ssm.A.dtype == torch.float64 else 1e-5
    rel = float(gap.abs().max() / ssm.Pinf.abs().max())
    if not rel <= tol:
        raise ValueError(
            f"the fused passes need the stationary discretization Q = Pinf - A Pinf A' "
            f"(max gap {rel:.3e} of max|Pinf|, tolerance {tol:g}); build the model with "
            f"discretization='stationary'")


def smoother_fused(ssm: BlockSSM, ms, Ps):
    """RTS pass over a (T, C, bs) / (T, C, bs, bs) filtered trajectory;
    returns C-major flat (T, C*bs), (T, C*bs*bs) (``smoother_pallas_bmajor``)."""
    pad = torch.diagonal(ssm.pad_eye, dim1=-2, dim2=-1)
    return _flat(*fused_bwd(ms, Ps, ssm.A, ssm.Q, pad))


def filter_smoother_fused(ssm: BlockSSM, sites: Sites):
    """Fixed-site filter + RTS smoother (``filter_smoother_pallas``).
    Returns C-major flat smoothed (ms (T, C*bs), Ps (T, C*bs*bs))."""
    check_stationary(ssm)
    ms, Ps = fused_fwd(sites.ttau, sites.tnu, ssm.A, ssm.Q, ssm.Pinf, ssm.H)
    return smoother_fused(ssm, ms, Ps)


def adf_filter_fused(mp: MomentParams, ssm: BlockSSM, W, sn2, y, mask, damp: float):
    """ADF sweep from zero sites (``adf_filter_pallas``).  Returns filtered
    (ms (T, C, bs), Ps (T, C, bs, bs)), lZ (T,), Sites (T, C)."""
    check_stationary(ssm)
    dt_, dev = ssm.A.dtype, ssm.A.device
    wn, xi = sigma_points(mp, dt_, dev)
    ms, Ps, lZ, tt, tn = fused_adf(
        torch.nan_to_num(y).to(dt_), mask.to(dt_), ssm.A, ssm.Q, ssm.Pinf, ssm.H,
        W.to(dt_), xi, wn, torch.as_tensor(sn2, dtype=dt_, device=dev),
        damp=damp, link=mp.link, variant=mp.variant, z_floor=mp.z_floor,
    )
    return ms, Ps, lZ, Sites(tt, tn)


def adf_filter_fused_mb(mp: MomentParams, ssmB: BlockSSM, WB, sn2B, yB, maskB, damp: float,
                        s_chunk: int = 0):
    """ADF sweep from zero sites over BF files (``adf_filter_pallas_mb``).

    ``ssmB`` has leaves (BF, C, ...); WB (BF, D, N); sn2B (BF,); yB, maskB
    (T, BF).  Returns filtered (ms (T, BF, C, bs), Ps (T, BF, C, bs, bs)),
    lZ (T, BF), Sites (T, BF, C)."""
    check_stationary(ssmB)
    dt_, dev = ssmB.A.dtype, ssmB.A.device
    wn, xi = sigma_points(mp, dt_, dev)
    ms, Ps, lZ, tt, tn = fused_adf_mb(
        torch.nan_to_num(yB).to(dt_), maskB.to(dt_), ssmB.A, ssmB.Q, ssmB.Pinf, ssmB.H,
        WB.to(dt_), xi, wn, torch.as_tensor(sn2B, dtype=dt_, device=dev),
        damp=damp, link=mp.link, variant=mp.variant, z_floor=mp.z_floor, s_chunk=s_chunk,
    )
    return ms, Ps, lZ, Sites(tt, tn)
