#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``nsgp_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (each prints its lines; any failure raises and the exit code is 1):

0. the card's name and power limit; build the CUDA kernels from
   ``nsgp_tpu_torch/csrc`` with nvcc (timed, one nvcc per source in parallel).
1. K1 fused_fwd, K2 fused_bwd, K3 fused_adf against their plain PyTorch
   versions on the card at the headline model's full width (D=16, N=3,
   matern32/matern52, p_cubature=9), T=4096, in float64 (proves the
   algorithm) and float32 (proves the working type); K1 and K2, which run
   as three blocked passes over chunks of T, also at T = 1, 31, 32 (one chunk),
   33 (a chunk and one step) and 4096 against the sequential plain versions,
   with sites that hold runs of zeros and one long gap, the last at the
   chunk length the main path launches with.  Then at the main path's own
   shape in float32, T=100 000 and the path's own chunk length: K3 against
   its plain version over the first 20 000 steps; K1 run over all T and held
   against the plain version on its first 20 000 rows (the filter is causal),
   K2 over all T against the plain version on its last 20 000 rows (the
   smoother runs from the end), and each over all T against the same kernel
   run as one chunk, which is the sequential pass; all timed over all T.
2. the single-signal path: ``ep_infer(backend="fused")`` at the headline
   benchmark shape (T=100 000, 3 EP sweeps, float32), launch counters reset
   just before one run and read just after; s/sweep over 3 timed runs, and
   one float64 run as the float32 health check.
3. real weights: ``results/trained/music/trained_piano_matern32.npz``,
   T=2048 from its prior, 3 sweeps on the card vs the CPU (plain versions).
4. K4 fused_adf_mb against its plain version: (a) batch width (BF=10, D=16,
   N=3, 77 sigma points, T=4096, masks that differ per file), (b) mixture
   width (BF=1, D=48, N=9, 3973 sigma points, s_chunk=256, T=512; then
   BF=3, three clusters of eight CTAs, T=128, signals and gaps that differ
   per file), each in float64 and float32, and s_chunk 0 against 256 on the
   kernel; K1 and K2 at the batched paths' channel counts C=190 and C=57,
   at the ragged lengths of phase 1 in both types, T=4096 at the chunk
   length those paths launch with.
   Every comparison also runs the kernel twice and wants the same bits.
5. the batched path: ``fill_gaps_batch(engine="ep", backend="fused")`` over
   the ten trained music models in one batch, padded to the corpus length
   T=53 248 with each file's own length and six 321-sample gaps, float32,
   seeded numpy draws from each model's prior; launch counters; files 0 and 9 against the
   single-file ``ep_infer``; s per batch call against the ten files one by
   one; K1 and K2 at the path's own shape (T=53 248, C=190) and chunk length
   as in phase 1: head and tail of 4096 rows against the plain versions, all
   T against the one-chunk kernel.
6. the mixture path: ``separate(engine="ep", backend="fused", s_chunk=256)``
   over three trained source models (joint D=48, N=9, 3973 sigma points),
   T=16 000, float32, a seeded synthetic mixture with known parts; launch
   counters; K4 ms per step and the re-site's time at this width; K1 and K2
   at the path's own shape (T=16 000, C=57) and chunk length as in phase 5;
   the same call at T=2048 in float64 on the card against the CPU.

The line before the last is ``{"kernels": [...]}``: per kernel its launches
on its path, max abs error vs plain, its time at the path's shape beside the
plain version's and the least time the card could take (``bound_ms``); K1 and
K2 also their chunk length, chunks, threads and launches a pass, all of the
launch the error was measured on.  The
last is ``{"ok": true, "device": {...}}``.  Without a CUDA device, or outside
a checkout, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# Headline benchmark shape (bench.py:93-110, gtnmf_ep_sweep_100k).
D, N, T_MAIN, EP_ITTS = 16, 3, 100_000, 3
T_KERNEL = 4096
T_PLAIN = 20_000  # steps of the main shape that the plain versions run
T_REAL = 2048
TRAINED = os.path.join("results", "trained", "music", "trained_piano_matern32.npz")

# The batched corpus path: results/missing_data_music_batched.json (lengths,
# pad_T), six gaps of 2*160+1 samples around the reference's hand-picked
# centres (missing_data_music.m:55-75, 1-based).
MUSIC = os.path.join("results", "trained", "music", "trained_{}_matern32.npz")
CORPUS = os.path.join("results", "missing_data_music_batched.json")
GAP_HALF = 160
CORPUS_KW = dict(ep_fraction=0.75, damping=(0.1,))  # experiments/missing_data.py:71: the
# default (0.5, 0.5) lets EP diverge on the files with large modulator variances
GAP_POSITIONS = {
    "bamboo_flute": (1500, 5000, 7000, 9000, 13000, 18000),
    "cello": (500, 1500, 3500, 5000, 8000, 10000),
    "clarinet": (1000, 2500, 4000, 5500, 6000, 7500),
    "flute": (800, 2200, 5000, 6500, 10000, 12500),
    "guitar": (700, 1600, 2500, 6000, 8000, 11000),
    "ocarina": (700, 2000, 3000, 4000, 5000, 7000),
    "piano": (800, 2000, 3000, 4000, 10000, 11000),
    "piccolo": (700, 2000, 5000, 6000, 9000, 10000),
    "sax": (1000, 2000, 5000, 8000, 12000, 13000),
    "toy-accordian": (1000, 3500, 7500, 8500, 10000, 15000),
}
# The mixture path (experiments/source_sep.py:30-45, 115-123).
SOURCES = [os.path.join("results", "trained", "source_sep", f"trained_011PFNOM_M{n}_exp.npz")
           for n in (60, 64, 67)]
T_MIX, T_MIX_F64, T_MIX_KERNEL = 16_000, 2048, 512
BF_MIX_KERNEL, T_MIX_FILES = 3, 128  # K4 with several clusters: files of the mixture model
MIX_KW = dict(s_chunk=256, moment_chunk=64, ep_fraction=0.75, damping=(0.025,), ep_itts=3,
              backend="fused")
MIX_LIK = 1e-4

# Kernel vs plain, relative to the reference output's max |value|.
# float64: the two differ only in summation order and FMA contraction
# (~1e-15 measured), so 1e-9 leaves six orders for T-long recursions.
TOL_F64 = 1e-9
# float32: eps is 6e-8; the filters are contractive, so rounding does not
# grow with T, but the ADF residual y - mean cancels digits once the sites
# converge and feeds back through the sites; 1e-3 still separates a
# wrong kernel (O(1) errors) from rounding.
TOL_F32 = 1e-3
# The same EP on the card (kernels) and the CPU (plain), float64.
TOL_REAL = 1e-8

# Published peaks of one H100 SXM: HBM3 bytes/s, float32 FLOP/s outside the
# tensor cores (the kernels use none).
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS_F32 = 67e12

# The Pallas kernel body each CUDA kernel replaces, and its source.
KERNELS = {
    "fused_fwd": ("nsgp_tpu/ops/pallas_kalman.py:112", "fused_kalman.cuh"),  # _fwd_kernel
    "fused_bwd": ("nsgp_tpu/ops/pallas_kalman.py:158", "fused_kalman.cuh"),  # _bwd_kernel
    "fused_adf": ("nsgp_tpu/ops/pallas_kalman.py:226", "fused_adf.cuh"),  # _adf_kernel
    "fused_adf_mb": ("nsgp_tpu/ops/pallas_kalman.py:341", "fused_adf_mb.cuh"),  # _adf_kernel_mb
}


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# The least time the card could take: bytes (each input read once, each output
# written once) over the memory rate, against operations over the float32
# rate.  Operations per step from the kernels' arithmetic, a multiply-add
# counted as 2.
# ---------------------------------------------------------------------------


def filter_flops(bs: int) -> int:
    """One channel, one step: predict (A m, A P, (A P) A' + Q), the
    marginals (H m, P H, H' P H) and the rank-one site update."""
    return 4 * bs**3 + 8 * bs**2 + 6 * bs + 5


def smoother_flops(bs: int) -> int:
    """One channel, one step: predict, Cholesky (bs^3 / 3), the bs
    triangular solve pairs (2 bs^3), G dm and G dP G' (4 bs^3)."""
    return round(10.34 * bs**3) + 8 * bs**2


def sigma_flops(D_: int, N_: int) -> int:
    """One sigma point, one step: a = W link(x) (2 D N), sqrt / s2e / mean
    and the A1, A2 terms (11 D), x, link and the G1, G2 terms (11 N), the
    log-normaliser and weight (13), and one add per moment row."""
    return 2 * D_ * N_ + 11 * D_ + 11 * N_ + 13 + (1 + 2 * D_ + 2 * N_)


def bound(n_bytes: float, flops: float):
    """(bound_ms, bound_by) on one H100 at its published float32 peaks."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, flops / PEAK_FLOPS_F32
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def bound_fwd(T, C, bs, itemsize=4):
    n = T * C * (2 + bs + bs * bs) + C * (3 * bs * bs + bs)
    return bound(n * itemsize, T * C * filter_flops(bs))


def bound_bwd(T, C, bs, itemsize=4):
    n = 2 * T * C * (bs + bs * bs) + C * (2 * bs * bs + bs)
    return bound(n * itemsize, T * C * smoother_flops(bs))


def bound_adf(T, BF, D_, N_, S, bs, observed_steps, itemsize=4):
    """K3 (BF = 1) and K4.  ``observed_steps``: (file, step) pairs whose
    sample is observed; only those run the cubature."""
    C = D_ + N_
    n = T * BF * (2 + 1 + 2 * C + C * (bs + bs * bs)) + BF * (C * (3 * bs * bs + bs) + D_ * N_ + 1) \
        + S * (N_ + 1)
    flops = T * BF * C * filter_flops(bs) + observed_steps * (S * sigma_flops(D_, N_) + 12 * C)
    return bound(n * itemsize, flops)


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------


def synth_signal(rng, omegas, T):
    """A seeded unit-variance signal with energy in the model's bands: one
    narrow-band carrier per centre frequency under a slow positive envelope
    (the construction of bench.py:147-155)."""
    freqs = np.fft.rfftfreq(T) * 2 * np.pi
    yh = np.zeros(T)
    for om in omegas:
        spec = np.fft.rfft(rng.normal(size=T))
        spec *= np.exp(-0.5 * ((freqs - om) / 0.02) ** 2)
        carrier = np.fft.irfft(spec, T)
        c = np.cumsum(rng.normal(size=T + 2000))
        env = np.abs(c[2000:] - c[:-2000]) / 2000.0 + 0.05
        yh += carrier / (carrier.std() + 1e-12) * env
    return yh / yh.std()


def bench_inputs(dtype, device):
    """bench.py:98-110 parameters and the seeded numpy signal of
    bench.py:147-155 (same generator, W drawn first)."""
    import torch

    from nsgp_tpu_torch.models.gtnmf import GTNMFModel, GTNMFParams

    model = GTNMFModel(D=D, N=N, kernel1="matern32", kernel2="matern52", p_cubature=9)
    rng = np.random.default_rng(0)
    omegas = np.linspace(0.05, 2.8, D)
    params = GTNMFParams(
        lik=np.float64(1e-3), sub_var=np.ones(D), sub_len=np.linspace(50.0, 300.0, D),
        omega=omegas, mod_var=np.full(N, 2.0),
        mod_len=np.linspace(800.0, 2500.0, N), W=rng.uniform(0.1, 1.0, (D, N)),
    ).to(dtype=dtype, device=device)
    y = synth_signal(rng, omegas, T_MAIN)
    return model, params, torch.tensor(y.astype(np.float32), device=device).to(dtype)


_MATERN = {"exp": (1.0, 1), "matern32": (3.0, 2), "matern52": (5.0, 3), "matern72": (7.0, 4)}


def _gp_paths(rng, kernel, var, ell, T, omega=0.0):
    """Seeded stationary GP paths (T, len(var)) by spectral synthesis:
    white noise shaped by the kernel's spectral density, a Matern of the given
    lengthscales centred at ``omega`` (the quasi-periodic subbands), scaled to
    the marginal variances.  Circular in T, which no phase here minds."""
    two_nu, power = _MATERN[kernel]
    lam = np.sqrt(two_nu) / np.asarray(ell)[:, None]
    w = (np.fft.rfftfreq(T) * 2 * np.pi)[None, :]
    om = np.broadcast_to(np.asarray(omega, dtype=float), lam.shape[:1])[:, None]
    dens = (lam**2 + (w - om) ** 2) ** -power + (lam**2 + (w + om) ** 2) ** -power
    spec = (rng.normal(size=dens.shape) + 1j * rng.normal(size=dens.shape)) * np.sqrt(dens)
    x = np.fft.irfft(spec, T, axis=1)
    x -= x.mean(1, keepdims=True) * (om == 0.0)
    return (x / x.std(1, keepdims=True) * np.sqrt(np.asarray(var))[:, None]).T


def prior_signal(rng, model, params, T):
    """A seeded numpy draw from a trained model's own prior: subbands and
    modulators from ``_gp_paths``, y = sum_d a_d z_d + noise with
    a = W softplus(g) ('amp') or its square root ('sq')."""
    p = {k: v.detach().cpu().numpy().astype(np.float64) for k, v in params.named_buffers()}
    z = _gp_paths(rng, model.kernel1, p["sub_var"], p["sub_len"], T, p["omega"])
    g = _gp_paths(rng, model.kernel2, p["mod_var"], p["mod_len"], T)
    a = np.logaddexp(g, 0.0) @ p["W"].T
    if model.variant == "sq":
        a = np.sqrt(a)
    return (a * z).sum(1) + np.sqrt(p["lik"]) * rng.normal(size=T)


def corpus_inputs(dtype, device):
    """The ten trained music models as one batch, each with a seeded numpy
    draw from its own prior of the file's own length, zero-padded to the
    corpus length, the reference's gaps, and the padding unobserved but not
    scored.  Returns (model, paramsB, yB, maskB, gapsB, lengths)."""
    import torch

    from nsgp_tpu_torch.convert import load_trained_batch

    with open(os.path.join(ROOT, CORPUS)) as f:
        rows = [r for r in json.load(f)["files"] if r["kernel1"] == "matern32"]
    names = [r["file"] for r in rows]
    pad_T = rows[0]["pad_T"]
    model, paramsB = load_trained_batch(
        [os.path.join(ROOT, MUSIC.format(n)) for n in names], device=device, dtype=dtype)
    yB = np.zeros((len(rows), pad_T))
    maskB = np.zeros((len(rows), pad_T), bool)
    gapsB = np.zeros((len(rows), pad_T), bool)
    for b, r in enumerate(rows):
        T_b = r["T"]
        yB[b, :T_b] = prior_signal(np.random.default_rng(100 + b), model, paramsB.select(b), T_b)
        maskB[b, :T_b] = True
        for p in GAP_POSITIONS[r["file"]]:
            gapsB[b, p - 1 - GAP_HALF: p + GAP_HALF] = True
    maskB &= ~gapsB
    as_t = lambda x, dt: torch.tensor(x, device=device).to(dt)
    return (model, paramsB, as_t(yB.astype(np.float32), dtype), as_t(maskB, torch.bool),
            as_t(gapsB, torch.bool), [r["T"] for r in rows])


def mixture_inputs(dtype, device, T):
    """Three trained source models and a seeded synthetic mixture with known
    parts: each part a numpy draw from its own model's prior, so the sum is a
    draw from the joint model's."""
    import torch

    from nsgp_tpu_torch.convert import load_trained

    models, params = zip(*[load_trained(os.path.join(ROOT, p), device=device, dtype=dtype)
                           for p in SOURCES])
    parts = np.stack([prior_signal(np.random.default_rng(200 + j), m, p, T)
                      for j, (m, p) in enumerate(zip(models, params))], axis=-1)
    parts = torch.tensor(parts.astype(np.float32), device=device).to(dtype)
    return models, params, parts.sum(-1), parts


def random_sites(T, C, seed):
    """Sites as in tests/test_pallas_kalman.py:32-37, from numpy."""
    rng = np.random.default_rng(seed)
    ttau = rng.uniform(0.0, 5.0, (T, C)) * (rng.uniform(size=(T, C)) > 0.2)
    return ttau, rng.normal(size=(T, C)) * ttau


def gappy_sites(T, C, seed):
    """``random_sites`` with runs of zero sites (five whole rows, seven steps
    of every third channel) and one long gap, a third of the signal."""
    ttau, tnu = random_sites(T, C, seed)
    live = np.ones((T, C))
    live[T // 8: T // 8 + 5] = 0.0
    live[T // 4: T // 4 + 7, ::3] = 0.0
    live[T // 2: T // 2 + T // 3] = 0.0
    return ttau * live, tnu * live


# ---------------------------------------------------------------------------
# Comparing and timing
# ---------------------------------------------------------------------------


def max_err(outs, refs):
    """(max abs error, max error relative to each reference's max |value|)."""
    worst_abs = worst_rel = 0.0
    for a, b in zip(outs, refs):
        d = (a - b).abs().max().item()
        scale = max(b.abs().max().item(), 1e-300)
        if not math.isfinite(d):
            return math.inf, math.inf
        worst_abs = max(worst_abs, d)
        worst_rel = max(worst_rel, d / scale)
    return worst_abs, worst_rel


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` in ms over ``reps`` runs, after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def host_s(fn):
    """(result, seconds on the host clock, synchronised at both ends)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def timed_plain(plain):
    """(outputs, device ms) of one run of a plain version."""
    import torch

    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    out = plain()
    e1.record()
    torch.cuda.synchronize()
    return out, e0.elapsed_time(e1)


def compare(label, name, kern, plain, tol, time_reps, timed=None, rows=slice(None)):
    """Hold one kernel call against its plain version on the same inputs:
    ``plain`` is a call, or the (outputs, ms) of a run already made, and
    covers the rows ``rows`` of the kernel's outputs.  Time ``timed``
    (default: the same kernel call) over ``time_reps`` runs."""
    import torch

    out_k = kern()
    if not all(torch.equal(a, b) for a, b in zip(out_k, kern())):
        raise AssertionError(f"{name} ({label}): two runs on the same inputs differ in their bits")
    out_p, plain_ms = plain if isinstance(plain, tuple) else timed_plain(plain)
    err_abs, err_rel = max_err([x[rows] for x in out_k], out_p)
    ms = cuda_ms(timed or kern, time_reps)
    log(f"{label} {name}: max_abs_err={err_abs:.3e} max_rel_err={err_rel:.3e} (tol {tol:g}) "
        f"kernel_ms={ms:.3f} plain_ms={plain_ms:.1f}")
    if not err_rel <= tol:
        raise AssertionError(f"{name} ({label}) disagrees with its plain version: "
                             f"rel err {err_rel:.3e} > {tol:g}")
    return dict(max_abs_err=err_abs, ms=ms, plain_ms=plain_ms)


def adf_case(model, params, y, mask, steps=None):
    """(kernel call, plain call) for K3 on the card, same inputs, over the
    first ``steps`` steps (default: all)."""
    from nsgp_tpu_torch.ops import fused_kalman as fk

    ssm = model.build_ssm(params)
    dt_, dev = ssm.A.dtype, ssm.A.device
    n = steps or y.shape[0]
    mp = model.moment_params()
    wn, xi = fk.sigma_points(mp, dt_, dev)
    kw = dict(damp=0.5, link=mp.link, variant=mp.variant, z_floor=mp.z_floor)
    args = (y[:n].to(dt_), mask[:n].to(dt_), ssm.A, ssm.Q, ssm.Pinf, ssm.H, params.W, xi, wn,
            params.lik)
    return lambda: fk.fused_adf(*args, **kw), lambda: fk.fused_adf_plain(*args, **kw)


def kalman_compare(label, ssm, sites_np, tol, time_reps):
    """K1 and K2 on the card against their sequential plain versions over all
    the steps of ``sites_np``, at the wrappers' own chunk length for that
    length.  K2 smooths the plain K1 trajectory, so both see identical
    inputs.  Returns {name: numbers}."""
    import torch

    from nsgp_tpu_torch.ops import fused_kalman as fk

    dt_, dev = ssm.A.dtype, ssm.A.device
    tt, tn = (torch.tensor(x, dtype=dt_, device=dev) for x in sites_np)
    pad = torch.diagonal(ssm.pad_eye, dim1=-2, dim2=-1)
    fwd_args = (tt, tn, ssm.A, ssm.Q, ssm.Pinf, ssm.H)
    ref_f = timed_plain(lambda: fk.fused_fwd_plain(*fwd_args))
    bwd_args = (*ref_f[0], ssm.A, ssm.Q, pad)
    shape = fk.blocked_launch_shape(*tt.shape)
    label = f"{label} chunk={shape['chunk']}"
    return {"fused_fwd": compare(label, "fused_fwd", lambda: fk.fused_fwd(*fwd_args), ref_f,
                                 tol, time_reps),
            "fused_bwd": compare(label, "fused_bwd", lambda: fk.fused_bwd(*bwd_args),
                                 lambda: fk.fused_bwd_plain(*bwd_args), tol, time_reps)}


def kalman_path_checks(label, ssm, sites_np, n_plain, tol, time_reps=3):
    """K1 and K2 at a main path's own shape, over all T of ``sites_np`` and so
    with the chunk length and the chunks the path launches.  The plain
    versions are Python loops over T, so they run ``n_plain`` steps: K1's
    first ``n_plain`` rows against the plain filter of those steps (the filter
    is causal), K2's last ``n_plain`` rows against the plain smoother of that
    tail of the same filtered trajectory (the smoother starts at the end).
    Over all T each is held against the same kernel run as one chunk, which is
    the sequential pass that the ragged checks hold against the plain version:
    that covers the carries of every chunk.  Returns {name: numbers}, timed
    over all T."""
    import torch

    from nsgp_tpu_torch.ops import fused_kalman as fk

    dt_, dev = ssm.A.dtype, ssm.A.device
    tt, tn = (torch.tensor(x, dtype=dt_, device=dev) for x in sites_np)
    T, C = tt.shape
    pad = torch.diagonal(ssm.pad_eye, dim1=-2, dim2=-1)
    model_args = (ssm.A, ssm.Q, ssm.Pinf, ssm.H)
    shape = fk.blocked_launch_shape(T, C)
    label = f"{label} T={T} C={C} chunk={shape['chunk']} chunks={shape['chunks']}"
    fwd = lambda **kw: fk.fused_fwd(tt, tn, *model_args, **kw)
    filtered = fwd()
    bwd = lambda **kw: fk.fused_bwd(*filtered, ssm.A, ssm.Q, pad, **kw)
    head, tail = slice(0, n_plain), slice(T - n_plain, T)
    out = {
        "fused_fwd": compare(f"{label} (plain over the first {n_plain} steps)", "fused_fwd", fwd,
                             lambda: fk.fused_fwd_plain(tt[head], tn[head], *model_args), tol,
                             time_reps, rows=head),
        "fused_bwd": compare(f"{label} (plain over the last {n_plain} steps)", "fused_bwd", bwd,
                             lambda: fk.fused_bwd_plain(filtered[0][tail], filtered[1][tail],
                                                        ssm.A, ssm.Q, pad), tol, time_reps,
                             rows=tail),
    }
    for name, kern in (("fused_fwd", fwd), ("fused_bwd", bwd)):
        err_abs, err_rel = max_err(kern(), kern(_chunk=T))
        log(f"{label} {name}: all T against the one-chunk kernel max_abs_err={err_abs:.3e} "
            f"max_rel_err={err_rel:.3e} (tol {tol:g})")
        if not err_rel <= tol:
            raise AssertionError(f"{name} ({label}): the blocked passes disagree with the "
                                 f"sequential pass over all T: rel err {err_rel:.3e} > {tol:g}")
        out[name].update(one_chunk_max_abs_err=err_abs, plain_steps=n_plain, **shape)
    return out


def adf_mb_case(model, paramsB, yB, maskB, s_chunk, steps=None, **kernel_only):
    """(kernel call, plain call) for K4; yB, maskB (BF, T).  ``kernel_only``
    goes to the kernel's wrapper alone (the cycle probe's library)."""
    from nsgp_tpu_torch.ops import fused_kalman as fk

    ssmB = model.build_ssm_batch(paramsB)
    dt_, dev = ssmB.A.dtype, ssmB.A.device
    mp = model.moment_params()
    wn, xi = fk.sigma_points(mp, dt_, dev)
    n = steps or yB.shape[1]
    args = (yB[:, :n].T.contiguous().to(dt_), maskB[:, :n].T.contiguous().to(dt_), ssmB.A,
            ssmB.Q, ssmB.Pinf, ssmB.H, paramsB.W, xi, wn, paramsB.lik)
    kw = dict(damp=0.5, link=mp.link, variant=mp.variant, z_floor=mp.z_floor, s_chunk=s_chunk)
    return (lambda: fk.fused_adf_mb(*args, **kw, **kernel_only),
            lambda: fk.fused_adf_mb_plain(*args, **kw))


def blocked_checks(label, ssm, tol, seed, path_chunk):
    """K1 and K2 (three blocked passes over chunks of T) against their
    sequential plain versions at ragged lengths: one step, just under a
    chunk, one chunk, a chunk and one step, and 4096 steps in chunks of
    ``path_chunk``, the length the main path at this width launches with;
    twice each for the same bits; padded state dims exactly zero."""
    import torch

    from nsgp_tpu_torch.ops import fused_kalman as fk

    dt_, dev = ssm.A.dtype, ssm.A.device
    C = ssm.num_channels
    pad = torch.diagonal(ssm.pad_eye, dim1=-2, dim2=-1)
    dead = pad > 0
    L = fk.MIN_CHUNK
    for T in (1, 31, L, L + 1, T_KERNEL):
        tt, tn = (torch.tensor(x, dtype=dt_, device=dev) for x in gappy_sites(T, C, seed))
        fwd_args = (tt, tn, ssm.A, ssm.Q, ssm.Pinf, ssm.H)
        ref_f = fk.fused_fwd_plain(*fwd_args)
        bwd_args = (*ref_f, ssm.A, ssm.Q, pad)
        chunk = path_chunk if T == T_KERNEL else None
        shape = fk.blocked_launch_shape(T, C, chunk)
        errs = {}
        for name, kern, plain in (("fused_fwd", fk.fused_fwd, lambda: ref_f),
                                  ("fused_bwd", fk.fused_bwd,
                                   lambda: fk.fused_bwd_plain(*bwd_args))):
            args = fwd_args if name == "fused_fwd" else bwd_args
            out = kern(*args, _chunk=chunk)
            if not all(torch.equal(a, b) for a, b in zip(out, kern(*args, _chunk=chunk))):
                raise AssertionError(f"{name} ({label} T={T}): two runs differ in their bits")
            if bool(dead.any()) and (float(out[0][:, dead].abs().max()) != 0.0 or float(
                    (out[1] * (pad[:, :, None] + pad[:, None, :])).abs().max()) != 0.0):
                raise AssertionError(f"{name} ({label} T={T}): a padded state dim is not zero")
            errs[name] = max_err(out, plain())[1]
        log(f"{label} C={C} T={T} chunk={shape['chunk']} chunks={shape['chunks']}: "
            f"max_rel_err fused_fwd={errs['fused_fwd']:.3e} fused_bwd={errs['fused_bwd']:.3e} "
            f"(tol {tol:g})")
        for name, err in errs.items():
            if not err <= tol:
                raise AssertionError(f"{name} ({label} C={C} T={T}) disagrees with its "
                                     f"sequential plain version: rel err {err:.3e} > {tol:g}")


def check_posterior(label, nlZ, Eft, Varft, shape):
    import torch

    if tuple(Eft.shape) != shape or tuple(Varft.shape) != shape:
        raise AssertionError(f"{label}: shapes {tuple(Eft.shape)}, {tuple(Varft.shape)} != {shape}")
    if not (bool(torch.isfinite(nlZ).all()) and bool(torch.isfinite(Eft).all())
            and bool(torch.isfinite(Varft).all()) and bool((Varft > 0).all())):
        raise AssertionError(f"{label}: non-finite energies or non-positive / non-finite "
                             f"variances")


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "nsgp_tpu_torch")):
        raise RuntimeError("chip_smoke.py must run from a checkout of the repository")
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this smoke test needs an NVIDIA GPU")

    from nsgp_tpu_torch.apps.missing_data import fill_gaps_batch
    from nsgp_tpu_torch.apps.source_sep import separate
    from nsgp_tpu_torch.convert import load_trained
    from nsgp_tpu_torch.inference import ep as ep_mod
    from nsgp_tpu_torch.inference.ep import EPConfig, ep_infer
    from nsgp_tpu_torch.models import mixture
    from nsgp_tpu_torch.models.gtnmf import sample_prior, stack_params
    from nsgp_tpu_torch.ops import _build
    from nsgp_tpu_torch.ops import fused_kalman as fk
    from nsgp_tpu_torch.ops.kalman import Sites
    from nsgp_tpu_torch.ops.ssm import flatten_files

    t_start = time.perf_counter()
    counts = lambda: {fn.__name__: fn.launches for fn in fk.WRAPPERS}

    # ---- phase 0: card, build ---------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(smi)
    log(f"phase0 device={kind} count={torch.cuda.device_count()} torch={torch.__version__} "
        f"cuda={torch.version.cuda}")
    t0 = time.perf_counter()
    _build.library()
    log(f"phase0 kernels built (nvcc, {len(_build.SOURCES)} sources in parallel) and loaded in "
        f"{time.perf_counter() - t0:.1f} s -> {_build.library_path()}")

    # ---- phase 1: K1-K3 vs their plain versions ------------------------------
    dev = torch.device("cuda")
    for dtype, tol, label in ((torch.float64, TOL_F64, "f64"), (torch.float32, TOL_F32, "f32")):
        model, params, _ = bench_inputs(dtype, dev)
        gen = torch.Generator().manual_seed(0)
        y, _, _ = sample_prior(gen, model, params, T_KERNEL)  # CPU noise, card model
        mask = torch.ones(T_KERNEL, dtype=torch.bool, device=dev)
        mask[1000:1100] = False  # a gap: unobserved steps keep zero sites
        ssm = model.build_ssm(params)
        kalman_compare(f"phase1 {label} T={T_KERNEL}", ssm,
                       random_sites(T_KERNEL, D + N, seed=1), tol, time_reps=5)
        compare(f"phase1 {label} T={T_KERNEL}", "fused_adf", *adf_case(model, params, y, mask),
                tol, time_reps=5)
        blocked_checks(f"phase1 {label} blocked", ssm, tol, seed=7,
                       path_chunk=fk.chunk_length(T_MAIN, D + N))
    model, params, y = bench_inputs(torch.float32, dev)
    mask = torch.ones(T_MAIN, dtype=torch.bool, device=dev)
    single = kalman_path_checks("phase1 f32", model.build_ssm(params),
                                random_sites(T_MAIN, D + N, seed=2), T_PLAIN, TOL_F32)
    single["fused_adf"] = compare(
        f"phase1 f32 T={T_MAIN} (plain over {T_PLAIN} steps)", "fused_adf",
        *adf_case(model, params, y, mask, steps=T_PLAIN), TOL_F32, 3,
        timed=adf_case(model, params, y, mask)[0])
    bs = model.build_ssm(params).block_size
    single["fused_fwd"]["bound"] = bound_fwd(T_MAIN, D + N, bs)
    single["fused_bwd"]["bound"] = bound_bwd(T_MAIN, D + N, bs)
    single["fused_adf"]["bound"] = bound_adf(T_MAIN, 1, D, N, 77, bs, T_MAIN)

    # ---- phase 2: the single-signal path at the headline shape ----------------
    cfg = EPConfig(ep_itts=EP_ITTS, backend="fused", moment_chunk=8192)
    fk.reset_launches()
    res, first_s = host_s(lambda: ep_infer(model, params, y, None, cfg))
    launches_single = counts()
    want = {"fused_fwd": EP_ITTS - 1, "fused_bwd": EP_ITTS, "fused_adf": 1, "fused_adf_mb": 0}
    nlZ = res.nlZ.cpu().numpy()
    log(f"phase2 first run {first_s:.3f} s launches={launches_single} nlZ={nlZ.tolist()} "
        f"maxdiff={res.maxdiff.cpu().numpy().tolist()}")
    if launches_single != want:
        raise AssertionError(f"launch counts {launches_single} != {want}: the single-signal "
                             f"path missed a kernel")
    check_posterior("phase2", res.nlZ, res.Eft, res.Varft, (T_MAIN, D + N))
    if res.ms.shape != (T_MAIN, (D + N) * 4):
        raise AssertionError(f"unexpected state shape {tuple(res.ms.shape)}")
    runs = [host_s(lambda: ep_infer(model, params, y, None, cfg))[1] for _ in range(3)]
    s_sweep = float(np.mean(runs)) / EP_ITTS
    log(f"phase2 ep_infer fused f32 T={T_MAIN} {EP_ITTS} sweeps: runs_s={[round(r, 4) for r in runs]} "
        f"s/sweep={s_sweep:.4f} on {smi}")
    model64, params64, y64 = bench_inputs(torch.float64, dev)
    res64 = ep_infer(model64, params64, y64, None, cfg)
    gap_eft = (res.Eft.double() - res64.Eft).abs().max().item()
    nlZ64 = res64.nlZ.cpu().numpy()
    gap_nlz = float(np.max(np.abs(nlZ - nlZ64) / np.abs(nlZ64)))
    log(f"phase2 f32 health vs f64: max|Eft32-Eft64|={gap_eft:.3e} (max|Eft64|="
        f"{res64.Eft.abs().max().item():.3e}) nlZ rel gap={gap_nlz:.3e} nlZ64={nlZ64.tolist()}")
    if not (math.isfinite(gap_eft) and gap_nlz < 1e-3):
        raise AssertionError("float32 main path drifted from float64")
    del res, res64

    # ---- phase 3: real weights, card vs CPU ----------------------------------
    tmodel, tparams = load_trained(os.path.join(ROOT, TRAINED), device="cpu",
                                   dtype=torch.float64)
    gen = torch.Generator().manual_seed(0)
    y_r, _, _ = sample_prior(gen, tmodel, tparams, T_REAL)
    cfg_r = EPConfig(ep_itts=EP_ITTS, backend="fused")
    t0 = time.perf_counter()
    r_cpu = ep_infer(tmodel, tparams, y_r, None, cfg_r, device="cpu")
    cpu_s = time.perf_counter() - t0
    r_gpu = ep_infer(tmodel, tparams, y_r, None, cfg_r)  # default device: the card
    if r_gpu.Eft.device.type != "cuda":
        raise AssertionError("ep_infer with the default device did not run on the card")
    err_abs, err_rel = max_err([r_gpu.Eft.cpu(), r_gpu.Varft.cpu(), r_gpu.nlZ.cpu()],
                               [r_cpu.Eft, r_cpu.Varft, r_cpu.nlZ])
    log(f"phase3 {TRAINED} ({tmodel.variant}, D={tmodel.D}, N={tmodel.N}) T={T_REAL} f64: "
        f"card vs cpu max_abs_err={err_abs:.3e} max_rel_err={err_rel:.3e} (tol {TOL_REAL:g}) "
        f"cpu_plain_s={cpu_s:.2f} nlZ={r_gpu.nlZ.cpu().numpy().tolist()}")
    if not err_rel <= TOL_REAL:
        raise AssertionError("real-weight EP on the card disagrees with the CPU")
    log(f"phases 0-3 done at {time.perf_counter() - t_start:.0f} s")

    # ---- phase 4: K4 vs its plain version; K1, K2 at the batched widths --------
    batch = {}
    for dtype, tol, label in ((torch.float64, TOL_F64, "f64"), (torch.float32, TOL_F32, "f32")):
        cmodel, cparamsB, cyB, cmaskB, _, _ = corpus_inputs(dtype, dev)
        kern, plain = adf_mb_case(cmodel, cparamsB, cyB, cmaskB, 0, steps=T_KERNEL)
        batch = compare(f"phase4a {label} BF={cyB.shape[0]} D={cmodel.D} N={cmodel.N} "
                        f"T={T_KERNEL}", "fused_adf_mb", kern, plain, tol, time_reps=3)
        flat = flatten_files(cmodel.build_ssm_batch(cparamsB))
        blocked_checks(f"phase4 {label} blocked", flat, tol, seed=8,
                       path_chunk=fk.chunk_length(cyB.shape[1], flat.num_channels))
    kalman_compare(f"phase4 f32 C={flat.num_channels} T={T_KERNEL}", flat,
                   random_sites(T_KERNEL, flat.num_channels, seed=3), TOL_F32, time_reps=3)
    mix = {}
    for dtype, tol, label in ((torch.float64, TOL_F64, "f64"), (torch.float32, TOL_F32, "f32")):
        models, plist, y_mix, _ = mixture_inputs(dtype, dev, T_MIX_KERNEL)
        jm, jp, _ = mixture.join_models(models, plist, lik=MIX_LIK)
        jpB = stack_params([jp])
        S_mix = fk.sigma_points(jm.moment_params(), dtype, dev)[0].shape[0]
        flat = flatten_files(jm.build_ssm_batch(jpB))
        blocked_checks(f"phase4 {label} blocked", flat, tol, seed=9,
                       path_chunk=fk.chunk_length(T_MIX, flat.num_channels))
        kern, plain = adf_mb_case(jm, jpB, y_mix[None], torch.ones_like(y_mix[None]) > 0, 256)
        mix = compare(f"phase4b {label} BF=1 D={jm.D} N={jm.N} S={S_mix} s_chunk=256 "
                      f"T={T_MIX_KERNEL}", "fused_adf_mb", kern, plain, tol, time_reps=1)
        if dtype == torch.float64:
            one_chunk, _ = adf_mb_case(jm, jpB, y_mix[None], torch.ones_like(y_mix[None]) > 0, 0)
            _, rel = max_err(kern(), one_chunk())
            ms0 = cuda_ms(one_chunk, 1)
            log(f"phase4b f64 kernel s_chunk=256 vs s_chunk=0: max_rel_err={rel:.3e} "
                f"(tol {TOL_F64:g}); s_chunk=0 kernel_ms={ms0:.3f} (one code for both)")
            if not rel <= TOL_F64:
                raise AssertionError("streamed and one-chunk sigma sums disagree")
        # several files of the mixture model: a cluster a file, indexed by
        # blockIdx.x / R and % R; windows of the signal and gaps that differ
        yF = y_mix[: BF_MIX_KERNEL * T_MIX_FILES].reshape(BF_MIX_KERNEL, T_MIX_FILES)
        maskF = torch.ones_like(yF) > 0
        for b in range(BF_MIX_KERNEL):
            maskF[b, 20 + 7 * b: 30 + 11 * b] = False
        kern, plain = adf_mb_case(jm, stack_params([jp] * BF_MIX_KERNEL), yF, maskF, 256)
        compare(f"phase4b {label} BF={BF_MIX_KERNEL} D={jm.D} N={jm.N} S={S_mix} "
                f"cluster={fk.adf_launch_shape(S_mix)['cluster']} T={T_MIX_FILES}", "fused_adf_mb",
                kern, plain, tol, time_reps=1)
    if (jm.D, jm.N, S_mix) != (48, 9, 3973):
        raise AssertionError(f"mixture width is D={jm.D}, N={jm.N}, S={S_mix}")
    kalman_compare(f"phase4 f32 C={flat.num_channels} T={T_KERNEL}", flat,
                   random_sites(T_KERNEL, flat.num_channels, seed=4), TOL_F32, time_reps=3)
    del flat

    # ---- phase 5: the batched path at full width -------------------------------
    cmodel, cparamsB, cyB, cmaskB, cgapsB, lengths = corpus_inputs(torch.float32, dev)
    BF_c, T_c = cyB.shape
    C_c = cmodel.D + cmodel.N
    gap_kw = dict(engine="ep", n_samples=20, metric_gapsB=cgapsB, ep_itts=EP_ITTS,
                  backend="fused", **CORPUS_KW)
    run_batch = lambda: fill_gaps_batch(cmodel, cparamsB, cyB, cmaskB,
                                        generator=torch.Generator().manual_seed(0), **gap_kw)
    fk.reset_launches()
    gres, first_s = host_s(run_batch)
    launches_batch = counts()
    want = {"fused_adf_mb": 1, "fused_bwd": EP_ITTS, "fused_fwd": EP_ITTS - 1, "fused_adf": 0}
    rb = gres.result
    log(f"phase5 fill_gaps_batch BF={BF_c} T={T_c} lengths={lengths} f32 first call "
        f"{first_s:.3f} s launches={launches_batch}")
    log(f"phase5 nlZ[:, -1]={[round(v, 1) for v in rb.nlZ[:, -1].tolist()]} "
        f"snr_gaps_db={[round(v, 2) for v in gres.snr_gaps.tolist()]} (synthetic signals)")
    if launches_batch != want:
        raise AssertionError(f"launch counts {launches_batch} != {want}: the batched path "
                             f"missed a kernel")
    if rb.Eft.device.type != "cuda":
        raise AssertionError("fill_gaps_batch did not run on the card")
    check_posterior("phase5", rb.nlZ, rb.Eft, rb.Varft, (BF_c, T_c, C_c))
    if not (bool(torch.isfinite(gres.rmse_gaps).all()) and gres.y_hat.shape == (BF_c, T_c)):
        raise AssertionError("phase5: non-finite gap metrics")
    cfg_c = EPConfig(ep_itts=EP_ITTS, backend="fused", **CORPUS_KW)
    one_file = lambda b: ep_infer(cmodel, cparamsB.select(b), torch.where(
        cmaskB[b], cyB[b], torch.full_like(cyB[b], float("nan"))), cmaskB[b], cfg_c)
    for b in (0, BF_c - 1):
        r1 = one_file(b)
        _, rel = max_err([rb.Eft[b], rb.Varft[b], rb.nlZ[b]], [r1.Eft, r1.Varft, r1.nlZ])
        same = all(torch.equal(a, c) for a, c in zip((rb.Eft[b], rb.Varft[b]), (r1.Eft, r1.Varft)))
        log(f"phase5 file {b}: batch vs single-file ep_infer max_rel_err={rel:.3e} (tol "
            f"{TOL_F32:g}); same bits: {same} (chunk "
            f"{fk.chunk_length(T_c, BF_c * C_c)} in the batch, {fk.chunk_length(T_c, C_c)} alone)")
        if not rel <= TOL_F32:
            raise AssertionError(f"phase5: file {b} of the batch disagrees with ep_infer")
    del gres, rb, r1
    batch_runs = [host_s(run_batch)[1] for _ in range(3)]
    serial_runs = [host_s(lambda: [one_file(b) for b in range(BF_c)])[1] for _ in range(2)]
    batch_s, serial_s = float(np.mean(batch_runs)), float(np.mean(serial_runs))
    log(f"phase5 s per batch call={batch_s:.3f} (runs {[round(r, 3) for r in batch_runs]}), "
        f"per file={batch_s / BF_c:.3f}; the ten files one by one through ep_infer="
        f"{serial_s:.3f} s (runs {[round(r, 3) for r in serial_runs]}); "
        f"one-by-one / batch = {serial_s / batch_s:.2f} on {smi}")
    kern, _ = adf_mb_case(cmodel, cparamsB, cyB, cmaskB, 0)
    batch["ms"] = cuda_ms(kern, 3)
    observed = int(cmaskB.sum().item())
    bs_c = cmodel.build_ssm_batch(cparamsB).block_size
    batch["bound"] = bound_adf(T_c, BF_c, cmodel.D, cmodel.N, 77, bs_c, observed)
    log(f"phase5 K4 alone at BF={BF_c} T={T_c}: {batch['ms']:.1f} ms "
        f"({1e3 * batch['ms'] / T_c:.2f} us/step, {observed} observed (file, step) pairs)")
    C_w = BF_c * C_c
    wide = kalman_path_checks("phase5 f32", flatten_files(cmodel.build_ssm_batch(cparamsB)),
                              random_sites(T_c, C_w, seed=5), T_KERNEL, TOL_F32)
    wide["fused_fwd"]["bound"] = bound_fwd(T_c, C_w, bs_c)
    wide["fused_bwd"]["bound"] = bound_bwd(T_c, C_w, bs_c)
    del kern

    # ---- phase 6: the mixture path at full width -------------------------------
    models, plist, y_mix, parts = mixture_inputs(torch.float32, dev, T_MIX)
    run_mix = lambda: separate(models, plist, y_mix, engine="ep", true_sources=parts,
                               generator=torch.Generator(device=dev).manual_seed(0),
                               n_samples=20, mixture_lik=MIX_LIK, **MIX_KW)
    fk.reset_launches()
    sres, mix_s = host_s(run_mix)
    launches_mix = counts()
    rm = sres.result
    log(f"phase6 separate J=3 D={jm.D} N={jm.N} S={S_mix} T={T_MIX} f32: {mix_s:.3f} s "
        f"launches={launches_mix} nlZ={rm.nlZ.tolist()} "
        f"snr_db={[round(v, 2) for v in sres.snr.tolist()]} (synthetic mixture, not asserted)")
    if launches_mix != want:
        raise AssertionError(f"launch counts {launches_mix} != {want}: the mixture path "
                             f"missed a kernel")
    check_posterior("phase6", rm.nlZ, rm.Eft, rm.Varft, (T_MIX, jm.D + jm.N))
    if not (bool(torch.isfinite(sres.sources).all()) and sres.sources.shape == (T_MIX, 3)
            and rm.sites.ttau.shape == (1, T_MIX, jm.D + jm.N)):
        raise AssertionError("phase6: non-finite sources or unexpected shapes")
    jm, jp, _ = mixture.join_models(models, plist, lik=MIX_LIK)
    jpB = stack_params([jp])
    kern, _ = adf_mb_case(jm, jpB, y_mix[None], torch.ones_like(y_mix[None]) > 0, 256)
    mix["ms"] = cuda_ms(kern, 1)
    bs_m = jm.build_ssm(jp).block_size
    mix["bound"] = bound_adf(T_MIX, 1, jm.D, jm.N, S_mix, bs_m, T_MIX)
    cfg_m = EPConfig(**MIX_KW)
    all_seen = torch.ones(T_MIX, dtype=torch.bool, device=dev)
    _, resite_s = host_s(lambda: ep_mod._ep_resite(
        jm, jp, cfg_m, y_mix, all_seen, rm.Eft, rm.Varft,
        Sites(rm.sites.ttau[0], rm.sites.tnu[0]), cfg_m.damp(1)))
    log(f"phase6 K4 alone at mixture width: {mix['ms']:.1f} ms for T={T_MIX} = "
        f"{mix['ms'] / T_MIX:.4f} ms/step (T=96 000 would take {96.0 * mix['ms'] / T_MIX:.1f} s); "
        f"one re-site of all T (moment_chunk=64): {resite_s:.3f} s")
    C_m = jm.D + jm.N
    wide_m = kalman_path_checks("phase6 f32", flatten_files(jm.build_ssm_batch(jpB)),
                                random_sites(T_MIX, C_m, seed=6), T_KERNEL, TOL_F32)
    wide_m["fused_fwd"]["bound"] = bound_fwd(T_MIX, C_m, bs_m)
    wide_m["fused_bwd"]["bound"] = bound_bwd(T_MIX, C_m, bs_m)
    del sres, rm, kern
    m64, p64, y64m, parts64 = mixture_inputs(torch.float64, dev, T_MIX_F64)
    sep64 = lambda device: separate(m64, p64, y64m, engine="ep", true_sources=parts64,
                                    n_samples=0, mixture_lik=MIX_LIK, device=device, **MIX_KW)
    s_gpu = sep64(None)
    s_cpu, cpu_s = host_s(lambda: sep64("cpu"))
    err_abs, err_rel = max_err(
        [s_gpu.sources.cpu(), s_gpu.result.Eft.cpu(), s_gpu.result.Varft.cpu(),
         s_gpu.result.nlZ.cpu()],
        [s_cpu.sources, s_cpu.result.Eft, s_cpu.result.Varft, s_cpu.result.nlZ])
    log(f"phase6 separate T={T_MIX_F64} f64: card vs cpu max_abs_err={err_abs:.3e} "
        f"max_rel_err={err_rel:.3e} (tol {TOL_REAL:g}) cpu_plain_s={cpu_s:.1f}")
    if not err_rel <= TOL_REAL:
        raise AssertionError("mixture EP on the card disagrees with the CPU")
    log(f"all phases done at {time.perf_counter() - t_start:.0f} s")

    # ---- the kernels line --------------------------------------------------------
    # One entry per kernel at its main path's shape: K1-K3 the single-signal
    # path (phase 2), K4 the batched path (phase 5).  `launches` is that run's
    # count; `launches_by_path` has all three paths.  `plain_ms` is the plain
    # version over `plain_steps` steps (it is a Python loop over T: for K1
    # the first, for K2 the last `plain_steps` rows of the kernel's run over
    # all T, so `max_abs_err` is of the launch that `chunk` and `chunks`
    # describe; `one_chunk_max_abs_err` is over all T against the same kernel
    # as one sequential chunk); `other_shapes` holds the same numbers where
    # another path runs the kernel at another shape.  No single PyTorch call computes a T-long
    # data-dependent recursion, so `library_ms` is null throughout.
    def numbers(nums, shape, **more):
        nums = dict(nums)
        bound_ms, bound_by = nums.pop("bound")
        return dict(shape=shape, bound_ms=bound_ms, bound_by=bound_by, **nums, **more)

    def entry(name, nums, shape, path_launches, other=None, **more):
        replaces, source = KERNELS[name]
        e = dict(name=name, route="cuda", source=f"nsgp_tpu_torch/csrc/{source}",
                 replaces=replaces, launches=path_launches[name], library_ms=None,
                 **numbers(nums, shape, **more),
                 launches_by_path={"single": launches_single[name],
                                   "batch": launches_batch[name],
                                   "mixture": launches_mix[name]})
        if other:
            e["other_shapes"] = other
        return e

    s_shape = f"T={T_MAIN} C={D + N} bs=4 f32"
    w_shape = f"T={T_c} C={C_w} bs={bs_c} f32"
    m_shape = f"T={T_MIX} C={C_m} bs={bs_m} f32"
    kernels = [
        entry(name, single[name], s_shape, launches_single,
              [numbers(wide[name], w_shape), numbers(wide_m[name], m_shape)])
        for name in ("fused_fwd", "fused_bwd")
    ] + [
        entry("fused_adf", single["fused_adf"], f"T={T_MAIN} D={D} N={N} S=77 bs=4 f32",
              launches_single, plain_steps=T_PLAIN, **fk.adf_launch_shape(77)),
        entry("fused_adf_mb", batch,
              f"T={T_c} BF={BF_c} D={cmodel.D} N={cmodel.N} S=77 bs={bs_c} f32", launches_batch,
              [numbers(mix, f"T={T_MIX} BF=1 D={jm.D} N={jm.N} S={S_mix} s_chunk=256 bs={bs_m} "
                            f"f32", plain_steps=T_MIX_KERNEL, **fk.adf_launch_shape(S_mix))],
              plain_steps=T_KERNEL, **fk.adf_launch_shape(77)),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception as e:  # any failed phase: report, no result line
        print(f"chip_smoke FAILED: {type(e).__name__}: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
