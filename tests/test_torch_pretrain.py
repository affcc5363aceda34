"""Port parity: the pretraining pipeline, float64 on the CPU against the JAX
package on the same seeded numpy inputs.

- Pure functions at 1e-10 relative to each output's max: ``welch`` (odd and
  even windows, a signal shorter than the window), the spectra of exp,
  matern32 and matern52, ``_whittle_obj`` and its gradient,
  ``build_filterbank``, ``cosfreq_to_ar2``, ``ar2_lds_params``.
- ``steady_filterbank``, ``exact_filterbank`` (a NaN gap) and
  ``fft_filterbank`` at D=3, exp and matern32, T=512: every field at 1e-9 of
  its max.
- ``nmf_fp`` fed JAX's random starts, ``nmf_inf``, ``order_by_fastness`` at
  1e-10; the restart chosen is the same.
- The optimiser loops at 1e-7 after their steps: ``fit_probstft`` (its
  reassignments of dead and duplicate components, move for move),
  ``fit_probstft_staged``, ``demodulate`` / ``demodulate_channels`` (and the
  gradient of one step at odd and even T, where the imaginary parts of the DC
  and Nyquist bins have no effect on the signal), ``laplace_evidence``,
  ``learn_lengthscale``, ``tnmf`` / ``tnmf_inf`` fed JAX's draws,
  ``fit_segp``, ``fit_ar2fb``, ``sample_pfb`` fed JAX's noise.
- ``train_gtnmf_fixed_params`` end to end at D=4, N=2, T=2048 (the Whittle
  fit cut by ``filterbank_kwargs``, the NMF starts fed) at 1e-6, and the
  ``.npz`` artifact read across in both directions.
- Every entry point that takes arrays raises without a card when no device
  is given.

JAX's references compile once each (module fixtures, small static step
counts); the signals are numpy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsgp_tpu.pretrain import ar2 as jar2
from nsgp_tpu.pretrain import filterbank as jfb
from nsgp_tpu.pretrain import gppad as jgppad
from nsgp_tpu.pretrain import nmf as jnmf
from nsgp_tpu.pretrain import pipeline as jpipe
from nsgp_tpu.pretrain import segp as jsegp
from nsgp_tpu.pretrain import spectral as jspec
from nsgp_tpu_torch import convert
from nsgp_tpu_torch.pretrain import ar2 as tar2
from nsgp_tpu_torch.pretrain import filterbank as tfb
from nsgp_tpu_torch.pretrain import gppad as tgppad
from nsgp_tpu_torch.pretrain import nmf as tnmf
from nsgp_tpu_torch.pretrain import pipeline as tpipe
from nsgp_tpu_torch.pretrain import segp as tsegp
from nsgp_tpu_torch.pretrain import spectral as tspec
from torch_threads import one_torch_thread  # noqa: F401

CPU = "cpu"
KERNELS = ("exp", "matern32", "matern52")


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(port, ref, rtol, what=""):
    """max |port - ref| within rtol of max |ref| (complex: of the modulus)."""
    p, r = _np(port), np.asarray(ref)
    assert p.shape == r.shape, (what, p.shape, r.shape)
    err = np.max(np.abs(p - r)) / max(np.max(np.abs(r)), 1e-300)
    assert err <= rtol, f"{what}: rel err {err:.3e} > {rtol:g}"


def _fields_close(port, ref, rtol, skip=()):
    for name in ref._fields:
        if name not in skip:
            _close(getattr(port, name), getattr(ref, name), rtol, name)


def tones(T, freqs, seed, noise=0.1, width=0.01):
    """Seeded narrow-band noise around each frequency, plus white noise."""
    rng = np.random.default_rng(seed)
    w = np.fft.rfftfreq(T) * 2 * np.pi
    y = noise * rng.normal(size=T)
    for k, f in enumerate(freqs):
        spec = np.fft.rfft(rng.normal(size=T)) * np.exp(-0.5 * ((w - f) / width) ** 2)
        x = np.fft.irfft(spec, T)
        y += x / x.std() * (1.0 + 0.5 * k)
    return y


def slow_envelope(T, seed, ell=60.0):
    rng = np.random.default_rng(seed)
    k = np.exp(-0.5 * (np.arange(-300, 301) / ell) ** 2)
    return np.convolve(rng.normal(size=T + 600), k, "valid")[:T] / np.sqrt(k @ k)


# ---------------------------------------------------------------------------
# Pure functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("T,nwin", [(1000, 256), (1000, 255), (100, 256)])
def test_welch_matches_jax(T, nwin):
    y = np.random.default_rng(T + nwin).normal(size=T)
    w_t, s_t = tspec.welch(torch.tensor(y), nwin)
    w_j, s_j = jax.jit(jspec.welch, static_argnums=1)(jnp.asarray(y), nwin)
    _close(w_t, w_j, 1e-10, "omega")
    _close(s_t, s_j, 1e-10, "spec")


@pytest.mark.parametrize("kernel", KERNELS)
def test_spectra_match_jax(kernel):
    rng = np.random.default_rng(1)
    s2, lam, om = rng.uniform(0.2, 2.0, 5), rng.uniform(0.01, 0.3, 5), rng.uniform(0.1, 3.0, 5)
    w = np.linspace(0.0, np.pi, 300)
    args_t = [torch.tensor(x) for x in (s2, lam, om, w)]
    args_j = [jnp.asarray(x) for x in (s2, lam, om, w)]
    _close(tspec.component_spectra(kernel, *args_t), jspec.component_spectra(kernel, *args_j),
           1e-10, "component_spectra")
    _close(tspec.mixture_spectrum(kernel, *args_t), jspec.mixture_spectrum(kernel, *args_j),
           1e-10, "mixture_spectrum")


def test_whittle_objective_and_gradient_match_jax():
    rng = np.random.default_rng(2)
    D = 4
    p = np.concatenate([rng.normal(-1.0, 0.3, D), rng.normal(-3.0, 0.3, D), rng.normal(0, 1, D),
                        [-3.0]])
    w, target = np.linspace(0.02, 3.1, 200), rng.uniform(0.01, 2.0, 200)
    for kernel in ("exp", "matern32"):
        pt = torch.tensor(p, requires_grad=True)
        val = tspec._whittle_obj(kernel, pt, torch.tensor(w), torch.tensor(target), 3.0)
        (g,) = torch.autograd.grad(val, pt)
        vj, gj = jax.jit(jax.value_and_grad(lambda q: jspec._whittle_obj(
            kernel, q, jnp.asarray(w), jnp.asarray(target), 3.0)))(jnp.asarray(p))
        _close(val, vj, 1e-10, "value")
        _close(g, gj, 1e-10, "gradient")


@pytest.mark.parametrize("kernel", ["exp", "matern32"])
def test_build_filterbank_matches_jax(kernel):
    s2, ell, om = np.array([0.5, 1.0, 0.8]), np.array([40.0, 25.0, 60.0]), np.array([0.4, 1.1, 2.2])
    fb_t = tfb.build_filterbank(s2, ell, om, kernel=kernel, noise=0.05, device=CPU)
    fb_j = jax.jit(jfb.build_filterbank, static_argnames="kernel")(
        jnp.asarray(s2), jnp.asarray(ell), jnp.asarray(om), kernel=kernel, noise=0.05)
    _fields_close(fb_t, fb_j, 1e-10, skip=("D", "block", "noise"))
    assert (fb_t.D, fb_t.block) == (int(fb_j.D), int(fb_j.block))


def test_ar2_closed_forms_match_jax():
    rng = np.random.default_rng(3)
    cf, df, mv = rng.uniform(-0.9, 0.9, 4), rng.uniform(0.02, 0.3, 4), rng.uniform(0.5, 2, 4)
    w = np.linspace(0, np.pi, 100)

    def closed_forms(ar2, t, cf, df, mv, w):
        Lam, Var = ar2.cosfreq_to_ar2(cf, df, mv)
        return (Lam, Var, ar2.ar2_marginal_var(Lam, Var),
                ar2.ar2_component_spectra(Lam, Var, w)) + tuple(ar2.ar2_lds_params(Lam, Var, 0.01))

    outs_t = closed_forms(tar2, *(torch.tensor(x) for x in (0, cf, df, mv, w)))
    outs_j = jax.jit(lambda *a: closed_forms(jar2, 0, *a))(
        *(jnp.asarray(x) for x in (cf, df, mv, w)))
    for name, a, b in zip(("Lam", "Var", "mVar", "spectra", "A", "Q", "C", "R", "x0", "P0"),
                          outs_t, outs_j):
        _close(a, b, 1e-10, name)


# ---------------------------------------------------------------------------
# Filterbank transforms
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=["exp", "matern32"])
def filterbanks(request):
    kernel = request.param
    T = 512
    y = tones(T, (0.5, 1.4), seed=4)
    y_gap = y.copy()
    y_gap[200:240] = np.nan
    s2, ell, om = np.array([0.6, 1.0, 0.4]), np.array([30.0, 45.0, 20.0]), np.array([0.5, 1.4, 2.5])
    noise_t = 0.05 + 0.05 * np.sin(np.arange(T) / 40.0) ** 2
    fb_j = jfb.build_filterbank(jnp.asarray(s2), jnp.asarray(ell), jnp.asarray(om),
                                kernel=kernel, noise=0.05)
    fb_t = tfb.build_filterbank(s2, ell, om, kernel=kernel, noise=0.05, device=CPU)
    pad = int(3.0 * ell.max())  # fft_filterbank's default, given so JAX's can be jitted
    ref = dict(steady=jfb.steady_filterbank(fb_j, jnp.asarray(y)),
               exact=jax.jit(lambda y, nt: jfb.exact_filterbank(fb_j, y, noise_t=nt))(
                   jnp.asarray(y_gap), jnp.asarray(noise_t)),
               fft=jax.jit(lambda *a: jfb.fft_filterbank(*a, kernel=kernel, noise=0.05, pad=pad))(
                   jnp.asarray(s2), jnp.asarray(ell), jnp.asarray(om), jnp.asarray(y)))
    port = dict(steady=tfb.steady_filterbank(fb_t, torch.tensor(y), device=CPU),
                exact=tfb.exact_filterbank(fb_t, torch.tensor(y_gap),
                                           noise_t=torch.tensor(noise_t), device=CPU),
                fft=tfb.fft_filterbank(s2, ell, om, torch.tensor(y), kernel=kernel, noise=0.05,
                                       device=CPU))
    return port, ref


@pytest.mark.parametrize("which", ["steady", "exact"])
def test_kalman_filterbanks_match_jax(filterbanks, which):
    port, ref = filterbanks
    _fields_close(port[which], ref[which], 1e-9)


def test_fft_filterbank_matches_jax(filterbanks):
    port, ref = filterbanks
    _close(port["fft"], ref["fft"], 1e-9, "Z")


# ---------------------------------------------------------------------------
# NMF
# ---------------------------------------------------------------------------


def _envelopes(T, D, N, seed):
    rng = np.random.default_rng(seed)
    H = np.stack([np.logaddexp(slow_envelope(T, seed + n, 20.0 * (n + 1)), 0) for n in range(N)],
                 -1)
    return (H @ rng.uniform(0.2, 1.0, (D, N)).T) * rng.uniform(0.8, 1.2, (T, D))


def test_nmf_matches_jax_with_its_starts():
    T, D, N, R, iters = 300, 5, 2, 3, 60
    A = _envelopes(T, D, N, 5)
    kH, kW = jax.random.split(jax.random.PRNGKey(7))
    UH = jax.random.uniform(kH, (R, T, N), jnp.float64, 0.5, 1.5)
    UW = jax.random.uniform(kW, (R, D, N), jnp.float64, 0.5, 1.5)
    ref = jnmf.nmf_fp(jnp.asarray(A), N, iters, R, jax.random.PRNGKey(7))
    res = tnmf.nmf_fp(A, N, iters, R, init=(np.array(UH), np.array(UW)), device=CPU)
    _fields_close(res, ref, 1e-10)
    H_inf = tnmf.nmf_inf(A, res.W, iters=40, device=CPU)
    _close(H_inf, jnmf.nmf_inf(jnp.asarray(A), ref.W, 40), 1e-10, "nmf_inf")
    Ht, Wt = tnmf.order_by_fastness(res.H, res.W)
    Hj, Wj = jnmf.order_by_fastness(ref.H, ref.W)
    _close(Ht, Hj, 1e-10, "H ordered")
    _close(Wt, Wj, 1e-10, "W ordered")
    # drawn from a generator: the same shapes, and reproducible
    g = lambda: torch.Generator().manual_seed(3)
    a, b = (tnmf.nmf_fp(A, N, 5, R, generator=g(), device=CPU) for _ in range(2))
    assert a.H.shape == (T, N) and torch.equal(a.H, b.H)


def test_tnmf_matches_jax_with_its_draws():
    T, D, N, iters = 128, 4, 2, 30
    A = _envelopes(T, D, N, 6)
    kH, kW = jax.random.split(jax.random.PRNGKey(2))
    eH = np.array(jax.random.normal(kH, (T, N), jnp.float64))
    eW = np.array(jax.random.normal(kW, (D, N), jnp.float64))
    ell = np.array([20.0, 60.0])
    ref = jnmf.tnmf(jnp.asarray(A), N, jnp.asarray(ell), iters, key=jax.random.PRNGKey(2))
    res = tnmf.tnmf(A, N, ell, iters, init=(eH, eW), device=CPU)
    _fields_close(res, ref, 1e-7)
    _close(tnmf.tnmf_inf(A, res.W, ell, 25, device=CPU),
           jnmf.tnmf_inf(jnp.asarray(A), ref.W, jnp.asarray(ell), 25), 1e-7, "tnmf_inf")


# ---------------------------------------------------------------------------
# Optimiser loops
# ---------------------------------------------------------------------------


def _record_moves(monkeypatch, module):
    moves = []
    inner = module._reassign_dead

    def wrapped(*args):
        p, moved = inner(*args)
        moves.append(moved)
        return p, moved

    monkeypatch.setattr(module, "_reassign_dead", wrapped)
    return moves


def test_fit_probstft_matches_jax_move_for_move(monkeypatch):
    """Four components on one tone: two collapse onto it by the final level,
    are moved, re-fitted and found clean.  (Where a re-fit after a move does
    not settle, as on two tones at 150 steps, the fit is chaotic in JAX as in
    the port: a perturbation of y at rounding level moves it at O(1), and no
    parity is owed; ``chip_smoke.py`` phase 9a measures that yardstick.)"""
    y = tones(2048, (0.6,), seed=8, noise=0.01)
    kw = dict(num_levels=3, min_win=64, max_win=512, steps_per_level=60)
    moves_j, moves_t = _record_moves(monkeypatch, jspec), _record_moves(monkeypatch, tspec)
    ref = jspec.fit_probstft(jnp.asarray(y), 4, kernel="exp", **kw)
    res = tspec.fit_probstft(y, 4, kernel="exp", device=CPU, **kw)
    assert moves_t == moves_j == [0, 0, 2, 0], (moves_t, moves_j)
    _fields_close(res, ref, 1e-7)
    # the reassignment alone, on the same inputs
    rng = np.random.default_rng(9)
    p = np.concatenate([[-9.0, 0.0, -0.5, -0.4], np.log([0.05, 0.02, 0.03, 0.03]),
                        [-1.0, 0.5, 0.51, 2.0], [-3.0]])
    w, target = np.linspace(0.01, 3.1, 150), rng.uniform(0.1, 1.0, 150)
    pt, mt = tspec._reassign_dead("exp", p, 4, w, target, 1.0, 0.01)
    pj, mj = jspec._reassign_dead("exp", p, 4, w, target, 1.0, 0.01)
    assert mt == mj == 2
    np.testing.assert_allclose(pt, pj, rtol=1e-12)


def test_fit_probstft_staged_matches_jax():
    y = tones(1024, (0.7, 1.9), seed=10)
    kw = dict(num_levels=1, min_win=256, max_win=256, steps_per_level=40)
    ref = jspec.fit_probstft_staged(jnp.asarray(y), 3, kernel="matern32", **kw)
    res = tspec.fit_probstft_staged(y, 3, kernel="matern32", device=CPU, **kw)
    _fields_close(res, ref, 1e-7)
    _close(res.lengthscales("matern32"), ref.lengthscales("matern32"), 1e-7, "lengthscales")


def _signal_with_envelope(T, seed):
    rng = np.random.default_rng(seed)
    return np.logaddexp(slow_envelope(T, seed, 25.0), 0.0) * rng.normal(size=T)


@pytest.mark.parametrize("T", [255, 256])
def test_gppad_gradient_of_one_step_matches_jax(T):
    """At a random point with nonzero imaginary parts in the DC (and, at even
    T, Nyquist) bins, which irfft ignores: torch's irfft backward and JAX's
    agree there too."""
    y = _signal_with_envelope(T, 11)
    F = T // 2 + 1
    ri = np.random.default_rng(12).normal(size=(2, F))
    S = np.asarray(jgppad.se_spectrum(T, 30.0, 1.0))
    vary = y.var()

    def jloss(r):
        return jgppad._map_objective(r[0] + 1j * r[1], jnp.asarray(y), jnp.asarray(S), vary)[0]

    vj, gj = jax.jit(jax.value_and_grad(jloss))(jnp.asarray(ri))
    rt = torch.tensor(ri[None], requires_grad=True)
    vt = tgppad._map_objective(torch.complex(rt[:, 0], rt[:, 1]), torch.tensor(y[None]),
                               torch.tensor(S), torch.tensor(vary))[0].sum()
    (gt,) = torch.autograd.grad(vt, rt)
    _close(vt, vj, 1e-10, "value")
    _close(gt[0], gj, 1e-10, "gradient")
    # the DC imaginary part: the prior's pull only, in both
    np.testing.assert_allclose([float(gt[0, 1, 0]), float(gj[1, 0])], ri[1, 0], rtol=1e-12)


@pytest.mark.parametrize("T", [255, 256])
def test_demodulate_matches_jax(T):
    y = _signal_with_envelope(T, 13)
    ref = jgppad.demodulate(jnp.asarray(y), 30.0, 50)
    res = tgppad.demodulate(y, 30.0, 50, device=CPU)
    _fields_close(res, ref, 1e-7)


def test_demodulate_channels_matches_jax():
    Y = np.stack([_signal_with_envelope(200, s) for s in (14, 15, 16)], -1)
    ref = jgppad.demodulate_channels(jnp.asarray(Y), 25.0, 40)
    res = tgppad.demodulate_channels(Y, 25.0, 40, device=CPU)
    _fields_close(res, ref, 1e-7)


def test_laplace_evidence_and_learn_lengthscale_match_jax():
    y = _signal_with_envelope(256, 17)
    ells = np.array([10.0, 30.0, 90.0])
    best_t, evs_t = tgppad.learn_lengthscale(y, ells, steps=40, device=CPU)
    best_j, evs_j = jgppad.learn_lengthscale(jnp.asarray(y), ells, steps=40)
    _close(evs_t, evs_j, 1e-7, "evidences")
    assert best_t == best_j


def test_fit_segp_matches_jax_one_and_batched():
    ys = np.stack([slow_envelope(400, s, 15.0 + 10 * s) for s in (18, 19)])
    refs = [jsegp.fit_segp(jnp.asarray(y), 80) for y in ys]
    one = tsegp.fit_segp(ys[0], 80, device=CPU)
    _fields_close(one, refs[0], 1e-7)
    both = tsegp.fit_segp(ys, 80, device=CPU)
    for b, ref in enumerate(refs):
        _fields_close(type(ref)(*(f[b] for f in both)), ref, 1e-7)


def test_fit_ar2fb_and_sample_pfb_match_jax():
    y = tones(1024, (0.5, 1.6), seed=20)
    kw = dict(num_levels=2, steps_per_level=50, min_win=64, max_win=256)
    ref = jar2.fit_ar2fb(jnp.asarray(y), 3, **kw)
    res = tar2.fit_ar2fb(y, 3, device=CPU, **kw)
    _fields_close(res, ref, 1e-7)
    key = jax.random.PRNGKey(4)
    kx, ky = jax.random.split(key)
    eps = np.array(jax.random.normal(kx, (300, 3), jnp.float64))
    obs = np.array(jax.random.normal(ky, (300,), jnp.float64))
    yt, Xt = tar2.sample_pfb(_np(res.Lam), _np(res.Var), 300, vary=0.01, eps=eps,
                             obs_noise=obs, device=CPU)
    yt_ref, Xt_ref = jar2.sample_pfb(key, jnp.asarray(_np(res.Lam)), jnp.asarray(_np(res.Var)),
                                     300, vary=0.01)
    _close(Xt, Xt_ref, 1e-9, "X")
    _close(yt, yt_ref, 1e-9, "y")


# ---------------------------------------------------------------------------
# The pipeline
# ---------------------------------------------------------------------------


T_PIPE, D_PIPE, N_PIPE = 2048, 4, 2
FB_KW = dict(num_levels=2, min_win=128, max_win=512, steps_per_level=40)


@pytest.fixture(scope="module")
def pipelines():
    y = tones(T_PIPE, (0.3, 0.9, 1.7, 2.6), seed=21) * np.logaddexp(
        slow_envelope(T_PIPE, 22, 150.0), 0.0)
    kH, kW = jax.random.split(jax.random.PRNGKey(0))
    init = (np.array(jax.random.uniform(kH, (8, T_PIPE, N_PIPE), jnp.float64, 0.5, 1.5)),
            np.array(jax.random.uniform(kW, (8, D_PIPE, N_PIPE), jnp.float64, 0.5, 1.5)))
    kw = dict(D=D_PIPE, N=N_PIPE, kernel1="exp", fs=2000.0, filterbank_kwargs=FB_KW)
    ref = jpipe.train_gtnmf_fixed_params(jnp.asarray(y), **kw)
    res = tpipe.train_gtnmf_fixed_params(y, nmf_init=init, device=CPU, **kw)
    return res, ref


def test_train_gtnmf_fixed_params_matches_jax(pipelines):
    res, ref = pipelines
    assert tuple(res.model) == tuple(ref.model)
    for name in ref.params._fields:
        _close(getattr(res.params, name), getattr(ref.params, name), 1e-6, name)
    _close(res.envelopes, ref.envelopes, 1e-6, "envelopes")
    _close(res.H, ref.H, 1e-6, "H")
    _fields_close(res.fit, ref.fit, 1e-6)
    assert res.fs == ref.fs and res.normaliser == ref.normaliser


def test_trained_artifacts_cross_both_ways(pipelines, tmp_path):
    res, ref = pipelines
    p_t, p_j = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    tpipe.save_trained(p_t, res)
    jpipe.save_trained(p_j, ref)
    from_port = jpipe.load_trained(p_t, full=True)
    from_jax = tpipe.load_trained(p_j, device=CPU, full=True)
    assert tuple(from_port.model) == tuple(ref.model) and from_jax.model == res.model
    for a, b in ((from_port, res), (from_jax, ref)):
        for name in ref.params._fields:
            _close(getattr(a.params, name), getattr(b.params, name), 0.0, name)
        for name in ("sigma2", "lam", "omega", "noise"):
            _close(getattr(a.fit, name), getattr(b.fit, name), 0.0, name)
        assert (a.fs, a.normaliser) == (b.fs, b.normaliser)
    model, params = convert.load_trained(p_j, device=CPU)
    assert model == res.model and torch.equal(params.W, from_jax.params.W)


# ---------------------------------------------------------------------------
# The device rule
# ---------------------------------------------------------------------------


def test_entry_points_need_a_card_or_the_cpu_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None is the card")
    y = np.random.default_rng(0).normal(size=64)
    A = np.abs(np.random.default_rng(1).normal(size=(64, 3))) + 0.1
    calls = [
        lambda **d: tspec.fit_probstft(y, 2, num_levels=1, min_win=16, max_win=16,
                                       steps_per_level=1, **d),
        lambda **d: tfb.build_filterbank([1.0], [10.0], [0.5], **d),
        lambda **d: tfb.fft_filterbank([1.0], [10.0], [0.5], y, **d),
        lambda **d: tgppad.demodulate(y, 5.0, 1, **d),
        lambda **d: tgppad.demodulate_channels(A, 5.0, 1, **d),
        lambda **d: tnmf.nmf_fp(A, 2, 1, 1, **d),
        lambda **d: tnmf.tnmf(A, 2, iters=1, **d),
        lambda **d: tsegp.fit_segp(y, 1, **d),
        lambda **d: tar2.fit_ar2fb(y, 2, num_levels=1, steps_per_level=1, min_win=16,
                                   max_win=16, **d),
        lambda **d: tar2.sample_pfb(np.array([[0.5, -0.2]]), np.array([1.0]), 8, **d),
        lambda **d: tpipe.train_gtnmf_fixed_params(y, D=2, N=1, kernel1="exp", **d),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    fb = tfb.build_filterbank([1.0], [10.0], [0.5], device=CPU)
    for transform in (tfb.steady_filterbank, tfb.exact_filterbank):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            transform(fb, y)
        assert transform(fb, y, device=CPU).Z.device.type == "cpu"
    assert calls[3](device=CPU).envelope.device.type == "cpu"
