"""Port parity: the experiment drivers that need no trained artifact from
JAX (``nsgp_tpu_torch/experiments``), float64 on the CPU.

- ``protocol``: the gap tables bit for bit against JAX's for every corpus
  file name, and the constants;
- ``missing_data.engine_config`` against JAX's on the CPU for every engine
  and ``itts``, and the fused backend on the card;
- ``synthetic.run`` fed JAX's draws (W and the prior sample), at 1e-8
  (one EP sweep, four IHGP sweeps, two GIEKF passes of two iterations);
- structure and sanity, as ``tests/test_experiments.py`` checks the JAX
  drivers, for source_sep (the committed note models), textures_ihgp,
  nonstationary_demo, filterbank_demo, hmc_hypers and hmc_sbc in process,
  at toy sizes on seeded wavs;
- every CLI: the default device is the card and every file it writes lies
  under ``results/torch/``.

The drivers fed a JAX-trained artifact (missing_data, train_hyperopt,
denoising) are in ``tests/test_torch_experiments.py``.  JAX runs with
``unroll=1`` where its config has it (compile time only), and its
``sample_prior`` under ``jax.jit`` (eager it costs seconds a shape).
"""

import os

import jax
import numpy as np
import pytest

import nsgp_tpu_torch.experiments as texps
from nsgp_tpu.experiments import missing_data as jmd
from nsgp_tpu.experiments import protocol as jproto
from nsgp_tpu.experiments import synthetic as jsyn
from nsgp_tpu.models import gtnmf as jgtnmf
from nsgp_tpu.utils.audio import write_wav
from nsgp_tpu_torch.experiments import missing_data as tmd
from nsgp_tpu_torch.experiments import protocol as tproto
from nsgp_tpu_torch.experiments import synthetic as tsyn
from torch_threads import one_torch_thread  # noqa: F401

FS = 16000
ENGINES = ("ep", "ihgp", "giekf")
JAX_FAST = {"ep": {"unroll": 1}, "ihgp": {"unroll": 1}, "giekf": {}}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


@pytest.fixture
def audio(tmp_path, monkeypatch):
    """A temporary audio root with speech/speech0_female (6400 samples of a
    seeded tone) as the drivers' ``AUDIO_ROOT``."""
    root = tmp_path / "audio"
    (root / "speech").mkdir(parents=True)
    t = np.arange(6400) / FS
    y = (np.sin(2 * np.pi * 440 * t) * (1.0 + 0.5 * np.sin(2 * np.pi * 2 * t))
         + 0.05 * np.random.default_rng(0).standard_normal(t.shape))
    write_wav(str(root / "speech" / "speech0_female.wav"), 0.5 * y / np.abs(y).max(), FS)
    monkeypatch.setattr(texps, "AUDIO_ROOT", str(root))
    return str(root)


# ---------------------------------------------------------------------------
# protocol and engine settings
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(jproto.GAP_POSITIONS))
def test_gap_tables_bit_equal(name):
    assert tproto.GAP_POSITIONS[name] == jproto.GAP_POSITIONS[name]
    for T in (700, 2048, 8000, 16000, 23296, 53248):
        if min(jproto.GAP_POSITIONS[name]) + jproto.GAP_HALF > T:  # no gap fits: both refuse
            for proto in (tproto, jproto):
                with pytest.raises(ValueError):
                    proto.reference_gap_indices(name, T)
            continue
        a, b = tproto.reference_gap_indices(name, T), jproto.reference_gap_indices(name, T)
        assert a.dtype == b.dtype and np.array_equal(a, b), (name, T)
        assert np.array_equal(tproto.reference_gap_mask(name, T),
                              jproto.reference_gap_mask(name, T))


def test_protocol_constants():
    for k in ("FS_REFERENCE", "GAP_HALF", "W_LIK_MISSING", "NOISE_LEVELS", "MUSIC_FILES",
              "SPEECH_FILES", "CORPUS_FILES"):
        assert getattr(tproto, k) == getattr(jproto, k), k


@pytest.mark.parametrize("itts", [1, 20])
@pytest.mark.parametrize("engine", ["ep", "ihgp", "ihgp_ref", "giekf"])
def test_engine_config_matches_jax(engine, itts):
    extra = {"moment_chunk": 64}
    assert tmd.engine_config(engine, itts, device="cpu") == jmd.engine_config(engine, itts)
    assert (tmd.engine_config(engine, itts, extra, device="cpu")
            == jmd.engine_config(engine, itts, extra))
    on_card = tmd.engine_config(engine, itts, device="cuda")  # JAX's "pallas" off the CPU
    assert on_card.get("backend") == ("fused" if engine == "ep" else None)


# ---------------------------------------------------------------------------
# synthetic against JAX on its draws
# ---------------------------------------------------------------------------


def test_synthetic_matches_jax_on_its_draws(monkeypatch):
    T, seed = 96, 0
    jit_prior = jax.jit(jgtnmf.sample_prior, static_argnums=(1, 3))
    monkeypatch.setattr(jsyn, "sample_prior", jit_prior)
    cut = {"giekf": {"g_iter": 2, "l_iter": 2}}
    want = jsyn.run(T=T, seed=seed, ep_itts=1, engine_kwargs={**JAX_FAST, **cut})
    jm, jp = jsyn.toy_model(seed=seed)
    draws = tuple(np.array(x) for x in jit_prior(jax.random.PRNGKey(seed + 1), jm, jp, T))
    got = tsyn.run(T=T, seed=seed, ep_itts=1, device="cpu", W=np.array(jp.W), sample=draws,
                   engine_kwargs=cut)
    assert got["config"] == want["config"]
    for eng in ENGINES:
        assert set(got[eng]) == set(want[eng])
        for k in ("rmse_sig", "rmse_sub", "rmse_mod", "nlZ_final"):
            if want[eng][k] is None:
                assert got[eng][k] is None
            else:
                assert _rel(got[eng][k], want[eng][k]) <= 1e-8, (eng, k)


# ---------------------------------------------------------------------------
# structure and sanity of the other drivers, at toy sizes
# ---------------------------------------------------------------------------


def test_source_sep_structure_and_sanity(audio, monkeypatch):
    """The committed 011PFNOM note models; a seeded mixture of three tones
    as the test recording, cut by ``TEST_IND`` to 512 samples (two frames
    of the log-spectral SNR)."""
    from nsgp_tpu_torch.experiments import source_sep

    test_dir = os.path.join(audio, "source_sep", "test_data")
    os.makedirs(test_dir, exist_ok=True)
    rng = np.random.default_rng(5)
    t = np.arange(1000) / FS
    parts = [np.sin(2 * np.pi * f * t + rng.uniform(0, 6)) * 0.3 for f in (262.0, 330.0, 392.0)]
    for p, y in zip(source_sep.PARTS, parts):
        write_wav(os.path.join(test_dir, f"011PFNOM_{p}_part.wav"), y, FS)
    write_wav(os.path.join(test_dir, "011PFNOM_mixture.wav"), sum(parts) / 3.0, FS)
    monkeypatch.setattr(source_sep, "TEST_IND", (200, 712))
    res = source_sep.run(ep_itts=1, n_samples=4, save_wavs=True, device="cpu",
                         wav_dir=os.path.join(audio, "wavs"))
    for k in ("snr_db", "snr_baseline_db", "log_spec_snr_db", "log_spec_snr_baseline_db"):
        assert len(res[k]) == 3 and np.isfinite(res[k]).all(), k
    assert (res["D_per_source"], res["N_per_source"], res["ep_itts"]) == (16, 3, 1)
    assert sorted(os.listdir(os.path.join(audio, "wavs"))) == [
        f"011PFNOM_{p}_est.wav" for p in source_sep.PARTS]


def test_textures_ihgp_structure_and_sanity(audio):
    from nsgp_tpu_torch.experiments import textures_ihgp

    path = os.path.join(audio, "textures", "stim312_wind.wav")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    write_wav(path, 0.3 * np.random.default_rng(3).standard_normal(800), FS)
    res = textures_ihgp.run_file(path, D=3, N=2, tile=2, n_gaps=2, ep_itts=1, device="cpu",
                                 pretrain_kwargs=dict(num_levels=1, steps_per_level=20,
                                                      max_win=512))
    assert res["T"] == 1600 and len(res["nlZ_per_sweep"]) == 1
    assert np.isfinite(res["snr_gaps_db"]) and np.isfinite(res["nlZ_per_sweep"]).all()
    assert res["filtered_samples_per_s"] > 0


def test_nonstationary_and_filterbank_demos_structure_and_sanity(audio):
    from nsgp_tpu_torch.experiments import filterbank_demo, nonstationary_demo

    res = nonstationary_demo.run(D=3, N=2, seconds=0.025, offset=100, ep_itts=1, device="cpu",
                                 pretrain_kwargs=dict(num_levels=1, steps_per_level=20,
                                                      max_win=512))
    assert res["T"] == 600 and [r["engine"] for r in res["engines"]] == list(ENGINES)
    assert all(np.isfinite(r["snr_db"]) for r in res["engines"])
    assert set(res["agreement"]) == {"ep_vs_ihgp_rel_rmse", "ep_vs_giekf_rel_rmse"}
    fb = filterbank_demo.run(D=3, seconds=0.05, gap=(400, 50), device="cpu",
                             fit_kwargs=dict(num_levels=1, steps_per_level=20, max_win=512))
    assert fb["T"] == 800 and len(fb["omega"]) == 3
    assert np.isfinite([fb["lml"], fb["snr_reconstruction_db"], fb["snr_gap_fill_db"]]).all()
    assert fb["snr_reconstruction_db"] > 0.0


def test_hmc_drivers_structure_and_sanity(monkeypatch):
    from nsgp_tpu_torch.experiments import hmc_hypers, hmc_sbc

    vi_fit = hmc_hypers.hmc.vi_fit  # the driver's 200 VI steps cut to 2 for time
    monkeypatch.setattr(hmc_hypers.hmc, "vi_fit", lambda *a, steps, **kw: vi_fit(*a, steps=2, **kw))
    res = hmc_hypers.run(T=8, n_chains=2, n_samples=4, n_warmup=2, device="cpu")
    assert [r["param"] for r in res["posterior"]] == [
        "lik", "mod_var[0]", "mod_var[1]", "mod_len[0]", "mod_len[1]"]
    assert len(res["accept_rate"]) == 2 and np.isfinite(res["energy_true"])
    assert np.isfinite([res["energy_post_mean"], res["energy_vi_mean"]]).all()
    sbc = hmc_sbc.run(runs=2, T=8, ep_itts_arms=(1,), n_chains=1, n_samples=4, thin=2,
                      arm_overrides={1: dict(n_leapfrog=2)}, subprocess_runs=False,
                      device="cpu")
    (arm,) = sbc["arms"]
    assert arm["runs"] == 2 and len(arm["per_param"]) == 5
    assert all(0.0 <= r["coverage_90ci"] <= 1.0 for r in arm["per_param"])


# ---------------------------------------------------------------------------
# the CLIs write under results/torch/
# ---------------------------------------------------------------------------


DRIVERS = ("synthetic", "toy_demo", "train_corpus", "missing_data", "train_hyperopt",
           "denoising", "source_sep", "textures_ihgp", "nonstationary_demo", "filterbank_demo",
           "hmc_hypers", "hmc_sbc")


@pytest.mark.parametrize("name", DRIVERS)
def test_cli_writes_under_results_torch(name, tmp_path, monkeypatch):
    """Each CLI with no arguments (``run`` stubbed): the default device is
    the card, and every file it writes lies under results/torch/."""
    import importlib
    import sys

    mod = importlib.import_module(f"nsgp_tpu_torch.experiments.{name}")
    calls = []

    def fake_run(*args, **kwargs):
        calls.append(kwargs)
        return {"aggregate": {}}

    for fn in ("run", "run_batched"):  # missing_data's default grid is run_batched
        if hasattr(mod, fn):
            monkeypatch.setattr(mod, fn, fake_run)
    monkeypatch.setattr(sys, "argv", [name])
    monkeypatch.chdir(tmp_path)
    mod.main()
    (kw,) = calls
    assert kw["device"] == "cuda"
    written = [os.path.relpath(os.path.join(d, f), tmp_path)
               for d, _, fs in os.walk(tmp_path) for f in fs]
    assert written and all(w.startswith(os.path.join("results", "torch", "")) for w in written)
    assert texps.TRAINED_OUT.startswith("results/torch/")
