"""Port parity: the experiment drivers fed a JAX-trained artifact
(``nsgp_tpu_torch/experiments``), float64 on the CPU.

- ``missing_data.run_file`` and ``run_batched`` on one synthetic wav and one
  tiny artifact trained once by JAX's ``train_corpus.run`` (as
  ``tests/test_experiments.py`` makes them), both packages loading the same
  files: rows at ``n_samples=0`` for ``ep``, ``ihgp`` and ``giekf`` against
  JAX's ``run_file`` at 1e-8 relative, one sweep (pass) an engine, timing
  fields left out (the wav is 2048 samples, so the batched grid's padded
  length is the file's own);
- ``train_hyperopt.run_file``: energies and learned parameters after 2
  Adam steps, at 1e-8 (on a 700-sample wav: one reference gap);
- structure and sanity of ``denoising`` on the artifact, as
  ``tests/test_experiments.py`` checks the JAX drivers.

The other drivers are in ``tests/test_torch_experiments_drivers.py``.  JAX
runs with ``unroll=1`` where its config has it (compile time only).
"""

import functools
import os
import shutil

import numpy as np
import pytest

import nsgp_tpu.experiments as jexps
import nsgp_tpu_torch.experiments as texps
from nsgp_tpu.experiments import missing_data as jmd
from nsgp_tpu.experiments import train_corpus as jtc
from nsgp_tpu.experiments import train_hyperopt as jho
from nsgp_tpu.utils.audio import write_wav
from nsgp_tpu_torch.experiments import missing_data as tmd
from nsgp_tpu_torch.experiments import train_corpus as ttc
from nsgp_tpu_torch.experiments import train_hyperopt as tho
from torch_threads import one_torch_thread  # noqa: F401

FS = 16000
T_MD, T_HO, T_DN = 2048, 700, 6400  # the gap, hyperopt and denoising wavs
ENGINES = ("ep", "ihgp", "giekf")
JAX_FAST = {"ep": {"unroll": 1}, "ihgp": {"unroll": 1}, "giekf": {}}
TIMING = ("seconds_cold", "seconds_warm", "batch_seconds_warm")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _tone(T, seed=0):
    """tests/test_experiments.py's synthetic 'piano' at 16 kHz."""
    t = np.arange(T) / FS
    y = (np.sin(2 * np.pi * 440 * t) * (1.0 + 0.5 * np.sin(2 * np.pi * 2 * t))
         + 0.05 * np.random.default_rng(seed).standard_normal(t.shape))
    return 0.5 * y / np.abs(y).max()


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A temporary audio root: music/piano (2048 samples: one reference gap,
    and the batched grid's padded length), music/cello (700: one gap),
    speech/speech0_female (6400: long enough for STOI); one tiny artifact
    trained by JAX's ``train_corpus.run`` on piano, copied under the other
    two names.  Both packages read these files."""
    tmp = tmp_path_factory.mktemp("experiments")
    audio, out = tmp / "audio", str(tmp / "trained")
    for corpus_, name, T in (("music", "piano", T_MD), ("music", "cello", T_HO),
                             ("speech", "speech0_female", T_DN)):
        (audio / corpus_).mkdir(parents=True, exist_ok=True)
        write_wav(str(audio / corpus_ / f"{name}.wav"), _tone(T), FS)
    mp = pytest.MonkeyPatch()
    for mod in (jexps, jtc, texps):
        mp.setattr(mod, "AUDIO_ROOT", str(audio))
    jtc.run(corpus="music", kernels=("exp",), D=4, N=2, out_dir=out, files=("piano",),
            pretrain_kwargs=dict(num_levels=1, steps_per_level=20, max_win=1024))
    os.makedirs(os.path.join(out, "speech"))
    src = os.path.join(out, "music", "trained_piano_exp.npz")
    shutil.copy(src, os.path.join(out, "music", "trained_cello_exp.npz"))
    shutil.copy(src, os.path.join(out, "speech", "trained_speech0_female_exp.npz"))
    j_load, t_load = jtc.load_corpus_model, ttc.load_corpus_model
    mp.setattr(jtc, "load_corpus_model", lambda c, n, k: j_load(c, n, k, out))
    mp.setattr(ttc, "load_corpus_model",
               lambda c, n, k, out_dir=None, **kw: t_load(c, n, k, out, **kw))
    yield str(audio), out
    mp.undo()


# ---------------------------------------------------------------------------
# missing_data on one wav and one JAX-trained artifact
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_rows(corpus):
    rows = {}
    for eng in ENGINES:
        r = jmd.run_file("music", "piano", engines=(eng,), ep_itts=(1,), n_samples=0,
                         engine_extra=JAX_FAST[eng])
        rows[eng] = r["rows"][0]
    return r, rows


def _check_rows(got, want):
    assert set(got) - {"batch_size", "batch_seconds_warm"} == set(want)
    for k, v in want.items():
        if k in TIMING:
            continue
        if isinstance(v, float):
            assert _rel(got[k], v) <= 1e-8, (k, got[k], v)
        else:
            assert got[k] == v, k


def test_missing_data_run_file_matches_jax(corpus, jax_rows):
    jres, jrows = jax_rows
    # a grid's later file: one warm call an arm (seconds_cold None)
    seen = {(eng, 1, "exp", T_MD) for eng in ENGINES}
    res = tmd.run_file("music", "piano", engines=ENGINES, ep_itts=(1,), n_samples=0,
                       seen_configs=seen, device="cpu")
    assert {k: v for k, v in res.items() if k != "rows"} == {
        k: v for k, v in jres.items() if k != "rows"}
    for row in res["rows"]:
        assert row["seconds_cold"] is None and row["seconds_warm"] > 0
        _check_rows(row, jrows[row["engine"]])


def test_missing_data_run_batched_matches_jax(corpus, jax_rows):
    _, jrows = jax_rows
    res = tmd.run_batched("music", files=("piano",), engines=ENGINES, ep_itts=(1,),
                          n_samples=0, device="cpu")
    (f,) = res["files"]
    assert (f["file"], f["T"], f["pad_T"], f["D"], f["N"]) == ("piano", T_MD, T_MD, 4, 2)
    assert [r["engine"] for r in f["rows"]] == list(ENGINES)
    for row in f["rows"]:
        assert row["batch_size"] == 1 and row["seconds_cold"] > 0
        _check_rows(row, jrows[row["engine"]])
    agg = res["aggregate"]
    assert set(agg) == {f"exp_{e}_itts1" for e in ENGINES}
    assert all(a["n_nonfinite"] == 0 for a in agg.values())
    row = f["rows"][0]
    assert agg["exp_ep_itts1"]["mean_snr_gaps_db"] == max(row["snr_gaps_db"], 0.0)


# ---------------------------------------------------------------------------
# train_hyperopt against JAX on the same inputs
# ---------------------------------------------------------------------------


def test_train_hyperopt_matches_jax(corpus, monkeypatch):
    kw = dict(steps=2, eval_itts=1)
    for mod, fn in ((jho.learn, "fit_hyperparams"), (jho.md, "fill_gaps")):
        monkeypatch.setattr(mod, fn, functools.partial(getattr(mod, fn), unroll=1))
    want = jho.run_file("music", "cello", **kw)
    got = tho.run_file("music", "cello", device="cpu", **kw)
    assert set(got) == set(want)
    assert {k: got[k] for k in ("file", "T", "D", "N", "steps", "ep_itts_train")} == {
        k: want[k] for k in ("file", "T", "D", "N", "steps", "ep_itts_train")}
    for k in ("energy_first", "energy_last", "energy_trace"):
        assert _rel(got[k], want[k]) <= 1e-8, k
    for k in ("lik", "mod_var", "mod_len", "W_mean"):
        assert _rel(got["learned"][k], want["learned"][k]) <= 1e-8, k
    # the gap fills draw their own Monte-Carlo noise: finite, not compared
    assert np.isfinite([got["snr_gaps_init_db"], got["snr_gaps_learned_db"]]).all()


# ---------------------------------------------------------------------------
# structure and sanity of the denoising driver on the artifact
# ---------------------------------------------------------------------------


def test_denoising_structure_and_sanity(corpus):
    from nsgp_tpu_torch.experiments import denoising

    res = denoising.run_file("speech", "speech0_female", engine="giekf", ep_itts=1,
                             noise_levels=(0.1,), n_samples=8, blend_arms=(0.0, 1.0),
                             device="cpu")
    (row,) = res["rows"]
    assert (res["T"], res["pad_T"], res["fs"]) == (T_DN, T_DN, FS)
    assert set(row["blend"]) == {"0.0", "1.0"}
    for k, v in row.items():
        if k != "blend":
            assert np.isfinite(v), k
    assert row["snr_out_db"] > row["snr_in_db"]  # the posterior read-out denoises
    assert 0.0 <= row["stoi_out"] <= 1.0


