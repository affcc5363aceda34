"""Port parity: the last three experiment drivers
(``nsgp_tpu_torch/experiments/{scaling_dryrun,figures,speech_fit_probe}.py``),
float64 on the CPU.

- ``scaling_dryrun.run`` in a world of 2 gloo ranks it spawns itself, cut to
  T=1024, D=4, N=2, chunk 256, no warm repeats (it runs while the other tests
  do): every arm within 1e-10 of
  the one-rank run, the chunk-total exchange counted with the bytes of its
  formula, the JAX file's keys;
- ``speech_fit_probe.run`` on one file with its committed arms on a
  prior-draw wav cut to 900 samples, EP cut to 1 sweep: the selection is the
  best validation arm; ``_gap_mask`` bit for bit against JAX's;
- ``figures``: the aggregates rendered from the committed JSONs, the
  spectrogram data at 1e-8 against the JAX driver's computation on the same
  noise draws (1024 samples, one EP sweep) and rendered; the gap-fill data
  (cut to one sweep, 1700 samples) and the source-separation data on seeded wavs,
  and their
  renderers;
- every CLI: the default device is the card and every file lies under
  ``results/torch/``.

Wavs are seeded prior draws of the committed trained models, written under
the test's temporary ``AUDIO_ROOT``.  JAX runs with ``unroll=1``.
"""

import concurrent.futures
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nsgp_tpu.experiments as jexps
import nsgp_tpu_torch.experiments as texps
from nsgp_tpu.apps import denoise as jdn
from nsgp_tpu.experiments import speech_fit_probe as jprobe
from nsgp_tpu.experiments import train_corpus as jtc
from nsgp_tpu.pretrain import filterbank as jfb
from nsgp_tpu_torch.convert import load_trained
from nsgp_tpu_torch.experiments import figures, scaling_dryrun, speech_fit_probe
from nsgp_tpu_torch.models.gtnmf import sample_prior
from nsgp_tpu_torch.utils.audio import write_wav
from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _prior_wav(root, corpus, name, model_path, T, seed):
    """A seeded draw of T samples from a trained model's prior, as a 16 kHz
    wav at ``root/corpus/name.wav``."""
    model, params = load_trained(os.path.join(ROOT, model_path), device="cpu",
                                 dtype=torch.float64)
    y = sample_prior(torch.Generator().manual_seed(seed), model, params, T)[0].numpy()
    os.makedirs(os.path.join(root, corpus), exist_ok=True)
    write_wav(os.path.join(root, corpus, f"{name}.wav"), 0.9 * y / np.abs(y).max(), 16000)


@pytest.fixture
def one_sweep(monkeypatch):
    """The drivers' EP@20 / IHGP@20 cut to one sweep (the sequential engine
    on the CPU runs about 0.3 ms a step)."""
    from nsgp_tpu_torch.experiments import missing_data

    engine_config = missing_data.engine_config
    monkeypatch.setattr(missing_data, "engine_config",
                        lambda engine, itts, *a, **kw: engine_config(engine, 1, *a, **kw))


@pytest.fixture
def audio(tmp_path, monkeypatch):
    root = str(tmp_path / "audio")
    monkeypatch.setattr(texps, "AUDIO_ROOT", root)
    monkeypatch.setattr(jexps, "AUDIO_ROOT", root)
    monkeypatch.setattr(jtc, "AUDIO_ROOT", root)  # bound at its import
    monkeypatch.chdir(ROOT)  # the committed results/ are read relative to the checkout
    return root


SCALING = dict(T=1024, D=4, N=2, chunk=256, mesh_sizes=(1, 2), reps=0, device="cpu")


@pytest.fixture(scope="module", autouse=True)
def scaling_world(tmp_path_factory):
    """``scaling_dryrun.run`` in the background: its ranks are processes of
    their own, so it runs beside the tests that follow."""
    save = str(tmp_path_factory.mktemp("scaling") / "results" / "torch" / "scaling_dryrun.json")
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        yield save, pool.submit(scaling_dryrun.run, save_path=save, **SCALING)


@pytest.mark.parametrize("T,shift", [(900, 0), (900, 2500), (30000, 2500)])
def test_gap_mask_bit_equal(T, shift):
    np.testing.assert_array_equal(speech_fit_probe._gap_mask("speech4_male", T, shift).numpy(),
                                  np.asarray(jprobe._gap_mask("speech4_male", T, shift)))


def test_speech_fit_probe_selects_on_validation(audio, one_sweep, tmp_path):
    name = "speech1_male"
    _prior_wav(audio, "speech", name, f"results/trained/speech/trained_{name}_matern32.npz",
               900, seed=4)
    save = str(tmp_path / "probe.json")
    out = speech_fit_probe.run([name], save_path=save, device="cpu")
    (row,) = out["files"]
    assert set(row["arms"]) == set(speech_fit_probe.ARMS)  # the committed arms all load
    vals = {a: r["val_snr_db"] for a, r in row["arms"].items()}
    assert all(np.isfinite(v) for v in vals.values())
    assert row["selected"] == max(vals, key=vals.get)
    assert np.isfinite(row["test_snr_db_base"]) and np.isfinite(row["test_snr_db_selected"])
    if row["selected"] == "base":
        assert row["test_snr_db_selected"] == row["test_snr_db_base"]
    with open(save) as f:
        assert json.load(f)["files"] == out["files"]


def test_spectrogram_data_matches_jax(audio, tmp_path):
    name, kernel, T, v = "speech2_male", "exp", 1024, 0.1
    _prior_wav(audio, "speech", name, f"results/trained/speech/trained_{name}_{kernel}.npz", T,
               seed=5)
    noise = np.random.default_rng(6).normal(size=T)
    data = figures.spectrogram_data(name, kernel, v, ep_itts=1, device="cpu", noise=noise)

    tm, y_norm = jtc.load_corpus_model("speech", name, kernel)
    y_noisy = jnp.asarray(y_norm) + np.sqrt(v) * jnp.asarray(noise)
    r = jdn.denoise(tm.model, tm.params, y_noisy, v, engine="ep", n_samples=50, ep_itts=1,
                    ep_fraction=0.75, damping=(0.1,), unroll=1)
    wfit = tm.fit
    S = jdn.stationary_spectrum(kernel, wfit.sigma2, wfit.lengthscales(kernel), wfit.omega,
                                dtype=y_noisy.dtype)
    y_hat = jdn.tv_wiener(tm.model, tm.params, r.result.Eft[:T], y_noisy, v, stat_spec=S,
                          stat_floor=1.0)
    Zw = jfb.fft_filterbank(wfit.sigma2, wfit.lengthscales(kernel), wfit.omega, y_noisy,
                            kernel=kernel, noise=v + float(jnp.maximum(wfit.noise, 1e-6)))
    want = [y_norm, y_noisy, y_hat, jnp.sum(jnp.real(Zw), axis=-1)]
    assert [p[0] for p in data["panels"]] == ["clean", f"noisy (v={v})", "GT-NMF TV-Wiener",
                                              "stationary Wiener"]
    for (title, got), ref in zip(data["panels"], want):
        assert _rel(got, np.asarray(ref)) <= 1e-8, title
    assert os.path.exists(figures.render_spectrograms(str(tmp_path), data))


def test_aggregates_render_from_committed_json(audio, tmp_path):
    panels = figures.aggregates_data()
    assert [c for c, _ in panels] == ["music", "speech"]
    with open(os.path.join(ROOT, "results", "missing_data_music_batched.json")) as f:
        assert panels[0][1] == json.load(f)["aggregate"]
    path = figures.fig_aggregates(str(tmp_path))
    assert path == os.path.join(str(tmp_path), "aggregates.png") and os.path.getsize(path) > 0


def test_gap_fill_and_source_sep_data_render(audio, one_sweep, tmp_path):
    _prior_wav(audio, "music", "bamboo_flute", "results/trained/music/trained_bamboo_flute_exp.npz",
               1700, seed=7)
    data = figures.gap_fill_data(gap_index=0, half_window=200, device="cpu")
    assert set(data["recons"]) == {"EP (20 sweeps)", "IHGP (20 sweeps)"}
    assert all(np.all(np.isfinite(y)) and y.shape == data["clean"].shape
               for y in data["recons"].values())
    assert data["gap"].sum() > 0
    # source separation: seeded test wavs of the right length, the committed estimates
    from nsgp_tpu_torch.experiments.source_sep import PARTS, TEST_IND

    test_dir = os.path.join(audio, "source_sep", "test_data")
    os.makedirs(test_dir)
    rng = np.random.default_rng(8)
    parts = {p: 0.3 * rng.normal(size=TEST_IND[1]) for p in PARTS}
    for p, y in parts.items():
        write_wav(os.path.join(test_dir, f"011PFNOM_{p}_part.wav"), y, 16000)
    write_wav(os.path.join(test_dir, "011PFNOM_mixture.wav"), sum(parts.values()) / 3, 16000)
    sep = figures.source_sep_data(window=(48000, 48400))
    assert set(sep["parts"]) == set(PARTS)
    assert all(t.shape == e.shape == (400,) and np.all(np.isfinite(e))
               for t, e in sep["parts"].values())
    for render, d in ((figures.render_gap_fill, data), (figures.render_source_sep, sep)):
        assert os.path.getsize(render(str(tmp_path), d)) > 0


@pytest.mark.parametrize("name", ["scaling_dryrun", "figures", "speech_fit_probe"])
def test_cli_defaults(name, tmp_path, monkeypatch):
    """Each CLI with its entry points stubbed: the default device is the
    card (and gloo for the mesh driver), and the outputs lie under
    results/torch/."""
    import inspect
    import sys

    mod = {"scaling_dryrun": scaling_dryrun, "figures": figures,
           "speech_fit_probe": speech_fit_probe}[name]
    out_dir = os.path.join("results", "torch", "")
    for fn in (scaling_dryrun.run, speech_fit_probe.run):
        assert inspect.signature(fn).parameters["save_path"].default.startswith(out_dir)
    assert speech_fit_probe.ARMS_OUT.startswith(out_dir)
    calls = []
    stub = lambda *a, **kw: calls.append((a, kw))
    fns = {"scaling_dryrun": ["run"], "speech_fit_probe": ["run"],
           "figures": ["fig_aggregates", "fig_source_sep", "fig_gap_fill", "fig_spectrograms"]}
    for fn in fns[name]:
        monkeypatch.setattr(mod, fn, stub)
    monkeypatch.setattr(sys, "argv", [name] + (["--phase", "eval"] * (name == "speech_fit_probe")))
    monkeypatch.chdir(tmp_path)
    mod.main()
    if name == "figures":
        assert [a[0] for a, _ in calls] == [out_dir + "figs"] * 4
        assert [kw.get("device") for _, kw in calls][2:] == ["cuda", "cuda"]
    else:
        ((_, kw),) = calls
        assert kw["device"] == "cuda"
        assert kw.get("backend", "gloo") == "gloo"


def test_scaling_dryrun_parity_and_collectives(scaling_world):
    T, D, N, chunk = (SCALING[k] for k in ("T", "D", "N", "chunk"))
    save, future = scaling_world
    out = future.result()
    with open(save) as f:
        assert json.load(f) == json.loads(json.dumps(out))
    with open(os.path.join(ROOT, "results", "scaling_dryrun.json")) as f:
        jax_out = json.load(f)
    assert set(jax_out) <= set(out) and set(jax_out["shape"]) <= set(out["shape"])
    assert [(a["arm"], a["devices"]) for a in out["arms"]] == [
        ("time_shard", 1), ("time_shard", 2), ("channel_shard", 1), ("channel_shard", 2)]
    scale = max(1.0, max(abs(a["max_abs_diff_vs_1dev"]) for a in out["arms"]))
    for arm in out["arms"]:
        assert set(jax_out["arms"][0]) - {"warm_seconds"} <= set(arm)
        assert arm["finite"] and arm["max_abs_diff_vs_1dev"] <= 1e-10 * scale, arm
    assert out["shape"]["n_devices"] == 2 and out["shape"]["backend"] == "gloo"
    # one later sweep: pass 2 of the filter and of the smoother, each one
    # gather of all nc chunk totals (3 bs^2 + 2 bs and 2 bs^2 + bs values a channel)
    C, bs, nc = D + N, 4, T // chunk
    time2 = out["arms"][1]["collectives"]
    assert time2["chunk_totals"] == {"count": 2, "bytes": nc * C * (5 * bs * bs + 3 * bs) * 8}
    assert out["arms"][3]["collectives"]["gather"]["count"] == 2 + 2  # marginals x2, ms, Ps
    assert out["arms"][0]["collectives"] == {} and out["arms"][2]["collectives"] == {}
    assert out["pass2_exchange_model"]["chunk_totals"] == nc
