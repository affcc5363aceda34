"""Port parity: the denoising application and the speech-quality metrics,
float64 on the CPU against the JAX package on the same seeded numpy inputs.

- ``denoise(engine="ep", n_samples=0)`` on ``backend="seq"`` (JAX's "xla")
  at the denoising protocol's EP settings (fraction 0.75, damping 0.1) with a
  NaN-padded tail, against JAX's ``denoise``: Eft, Varft, the read-out and
  both SNRs at 1e-8; the Monte-Carlo read-out is reproducible from its seed.
- ``tv_wiener`` at ``stat_floor`` 0 and 0.5 on JAX's posterior, with the
  ``stationary_spectrum`` of a stage-1 fit, and the ``fft_filterbank`` Wiener
  baseline, at 1e-8.
- ``loud_floor``, ``log_spec_snr_db``, ``fw_seg_snr`` at 1e-8; ``stoi`` and
  the WAV IO (numpy copies) give the JAX package's values exactly.
- ``denoise`` follows the device rule.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsgp_tpu.apps import denoise as jdn
from nsgp_tpu.models.gtnmf import GTNMFModel as JModel
from nsgp_tpu.models.gtnmf import GTNMFParams as JParams
from nsgp_tpu.pretrain import filterbank as jfb
from nsgp_tpu.utils import audio as jaudio
from nsgp_tpu.utils import metrics as jmetrics
from nsgp_tpu.utils import speech_quality as jsq
from nsgp_tpu.utils import stoi as jstoi
from nsgp_tpu_torch import convert
from nsgp_tpu_torch.apps import denoise as tdn
from nsgp_tpu_torch.models.gtnmf import GTNMFModel
from nsgp_tpu_torch.pretrain import filterbank as tfb
from nsgp_tpu_torch.utils import audio as taudio
from nsgp_tpu_torch.utils import metrics as tmetrics
from nsgp_tpu_torch.utils import speech_quality as tsq
from nsgp_tpu_torch.utils import stoi as tstoi
from torch_threads import one_torch_thread  # noqa: F401

CPU = "cpu"
T, PAD, D, N, FS = 1000, 24, 4, 2, 16000
NOISE = 0.05
EP_KW = dict(ep_itts=3, ep_fraction=0.75, damping=(0.1,))
# a stage-1 fit: channel variances, exp lengthscales, centres (rad/sample)
FIT = dict(sigma2=np.array([0.4, 0.3, 0.2, 0.1]), ell=np.array([40.0, 60.0, 30.0, 80.0]),
           omega=np.array([0.3, 0.8, 1.4, 2.2]))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(port, ref, rtol, what=""):
    p, r = _np(port), np.asarray(ref)
    assert p.shape == r.shape, (what, p.shape, r.shape)
    err = np.max(np.abs(p - r)) / max(np.max(np.abs(r)), 1e-300)
    assert err <= rtol, f"{what}: rel err {err:.3e} > {rtol:g}"


def speechlike(T, seed):
    """Seeded narrow-band carriers at the fit's centres under slow positive
    envelopes, unit variance."""
    rng = np.random.default_rng(seed)
    w = np.fft.rfftfreq(T) * 2 * np.pi
    y = np.zeros(T)
    for om in FIT["omega"]:
        c = np.fft.irfft(np.fft.rfft(rng.normal(size=T)) * np.exp(-0.5 * ((w - om) / 0.03) ** 2),
                         T)
        env = np.convolve(rng.normal(size=T + 400), np.hanning(401), "valid")[:T]
        y += c / c.std() * np.logaddexp(env / 5.0, 0.0)
    return y / y.std()


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(0)
    leaves = dict(lik=np.float64(1e-3), sub_var=np.full(D, 0.06), sub_len=FIT["ell"],
                  omega=FIT["omega"], mod_var=np.array([1.5, 2.0]),
                  mod_len=np.array([150.0, 400.0]), W=rng.uniform(0.2, 1.0, (D, N)))
    jm = JModel(D=D, N=N, kernel1="exp", kernel2="matern52", variant="sq", p_cubature=7)
    model = GTNMFModel(*jm)
    params = convert.params_from_numpy(leaves, device=CPU)
    y = speechlike(T, 1)
    y_noisy = y + np.sqrt(NOISE) * rng.normal(size=T)
    ypad = np.concatenate([y_noisy, np.full(PAD, np.nan)])
    ref = jdn.denoise(jm, JParams(**{k: jnp.asarray(v) for k, v in leaves.items()}),
                      jnp.asarray(ypad), NOISE, n_samples=0, unroll=1, **EP_KW)
    res = tdn.denoise(model, params, torch.tensor(ypad), NOISE, n_samples=0, device=CPU,
                      backend="seq", **EP_KW)
    return dict(jm=jm, jp=JParams(**{k: jnp.asarray(v) for k, v in leaves.items()}), model=model,
                params=params, y=y, y_noisy=y_noisy, ypad=ypad, ref=ref, res=res)


def test_denoise_matches_jax(case):
    ref, res = case["ref"], case["res"]
    _close(res.result.Eft, ref.result.Eft, 1e-8, "Eft")
    _close(res.result.Varft, ref.result.Varft, 1e-8, "Varft")
    _close(res.y_hat, ref.y_hat, 1e-8, "y_hat")
    assert np.isnan(_np(res.snr_in)) and np.isnan(_np(res.snr_out))
    # with the clean signal: the SNRs of the same read-out
    y_clean = np.concatenate([case["y"], np.zeros(PAD)])
    scored = tdn.denoise(case["model"], case["params"], torch.tensor(case["ypad"]), NOISE,
                         y_clean=torch.tensor(y_clean), n_samples=0, device=CPU,
                         backend="seq", **EP_KW)
    snr_out = jmetrics.snr_db(jnp.asarray(y_clean), ref.y_hat)
    _close(scored.snr_out, snr_out, 1e-8, "snr_out")
    assert float(scored.snr_out) > 0.0


def test_denoise_monte_carlo_is_reproducible(case):
    run = lambda: tdn.denoise(case["model"], case["params"], torch.tensor(case["ypad"]), NOISE,
                              generator=torch.Generator().manual_seed(5), n_samples=8,
                              device=CPU, backend="fused", ep_itts=2)
    a, b = run(), run()
    assert torch.equal(a.y_hat, b.y_hat) and bool(torch.isfinite(a.y_hat).all())


@pytest.mark.parametrize("stat_floor", [0.0, 0.5])
def test_tv_wiener_matches_jax(case, stat_floor):
    Eft = np.asarray(case["ref"].result.Eft)[:T]
    ell = FIT["ell"]
    S_t = tdn.stationary_spectrum("exp", torch.tensor(FIT["sigma2"]), torch.tensor(ell),
                                  torch.tensor(FIT["omega"]), dtype=torch.float64)
    S_j = jdn.stationary_spectrum("exp", jnp.asarray(FIT["sigma2"]), jnp.asarray(ell),
                                  jnp.asarray(FIT["omega"]), dtype=jnp.float64)
    _close(S_t, S_j, 1e-10, "stationary_spectrum")
    out_t = tdn.tv_wiener(case["model"], case["params"], torch.tensor(Eft),
                          torch.tensor(case["y_noisy"]), NOISE, stat_spec=S_t,
                          stat_floor=stat_floor)
    out_j = jax.jit(jdn.tv_wiener, static_argnums=(0, 4), static_argnames="stat_floor")(
        case["jm"], case["jp"], jnp.asarray(Eft), jnp.asarray(case["y_noisy"]), NOISE,
        stat_spec=S_j, stat_floor=stat_floor)
    _close(out_t, out_j, 1e-8, "tv_wiener")
    # the stationary Wiener baseline of the same fit
    Z_t = tfb.fft_filterbank(FIT["sigma2"], ell, FIT["omega"], torch.tensor(case["y_noisy"]),
                             noise=NOISE + 1e-4, device=CPU)
    Z_j = jfb.fft_filterbank(jnp.asarray(FIT["sigma2"]), jnp.asarray(ell),
                             jnp.asarray(FIT["omega"]), jnp.asarray(case["y_noisy"]),
                             noise=NOISE + 1e-4)
    _close(Z_t.real.sum(-1), jnp.sum(jnp.real(Z_j), -1), 1e-8, "wiener")


def test_spectral_metrics_match_jax(case):
    y, y_hat = case["y"], _np(case["res"].y_hat)[:T]
    S = np.abs(np.random.default_rng(3).normal(size=(20, 9))) ** 4
    _close(tmetrics.loud_floor(torch.tensor(S), -30.0),
           jmetrics.loud_floor(jnp.asarray(S), -30.0), 1e-12, "loud_floor")
    log_spec = jax.jit(jmetrics.log_spec_snr_db, static_argnums=(2, 3))
    for nwin, hop in ((256, 128), (101, 40)):
        _close(tmetrics.log_spec_snr_db(torch.tensor(y), torch.tensor(y_hat), nwin, hop),
               log_spec(jnp.asarray(y), jnp.asarray(y_hat), nwin, hop), 1e-8,
               f"log_spec_snr_db {nwin}")
    fw_seg = jax.jit(jsq.fw_seg_snr, static_argnums=2)
    for fs in (FS, 8000):
        _close(tsq.fw_seg_snr(torch.tensor(y), torch.tensor(y_hat), fs),
               fw_seg(jnp.asarray(y), jnp.asarray(y_hat), fs), 1e-8, f"fw_seg_snr {fs}")


def test_stoi_and_audio_copies_give_jax_values(tmp_path):
    y = speechlike(9000, 2)
    noisy = y + 0.5 * np.random.default_rng(4).normal(size=y.shape)
    for fs in (FS, 10_000):
        assert tstoi.stoi(y, noisy, fs) == jstoi.stoi(y, noisy, fs)
    assert tstoi.stoi(torch.tensor(y), torch.tensor(noisy), FS) == jstoi.stoi(y, noisy, FS)
    path = str(tmp_path / "y.wav")
    taudio.write_wav(path, 0.3 * y, 16000)
    a, b = taudio.load_normalized(path, 8000), jaudio.load_normalized(path, 8000)
    np.testing.assert_array_equal(a[0], b[0])
    assert a[1:] == b[1:]


def test_denoise_needs_a_card_or_the_cpu_asked_for(case):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None is the card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdn.denoise(case["model"], case["params"], torch.tensor(case["ypad"]), NOISE,
                    n_samples=0, ep_itts=1)
    assert case["res"].y_hat.device.type == "cpu"
