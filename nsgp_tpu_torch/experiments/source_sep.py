"""Piano 3-note source separation under the reference protocol
(ref source_sep_piano.m / train_source_sep.m / source_sep_results.m).

Port of ``nsgp_tpu/experiments/source_sep.py``.  Protocol:
- per note (MIDI 60/64/67): a D=16/N=3 'exp' GT-NMF model pre-trained on the
  whole 16 kHz training recording (train_source_sep.m:11-14): the committed
  artifact under ``results/trained/source_sep/`` when there is one, else
  trained here and cached under ``results/torch/trained/source_sep/``;
- test: the mixture recording resampled to 16 kHz and normalized by ITS
  variance; segment test_ind = 96001:192000 (source_sep_piano.m:110);
  ground-truth parts share the mixture's normaliser and are divided by 3
  (:116-125);
- joint inference: the three models stacked block-diagonally with mixture
  w_lik = 1e-4, ep_itts = 10, damping 0.025 (:57,:86-87); on the card EP
  runs the fused kernels at BF=1 with the sigma points streamed in chunks of
  256 (``s_chunk``) and the re-site in chunks of 64 sites;
- outputs: per-source SNR and log-spectral SNR against the mixture-as-
  estimate baseline, and the reconstructed per-source wavs.

CLI: python -m nsgp_tpu_torch.experiments.source_sep [--instrument 011PFNOM]
        [--device cuda|cpu]
Writes results/torch/source_sep_<instrument>_<engine>.json (+ wavs under
results/torch/wavs/).
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from nsgp_tpu_torch import experiments as exps
from nsgp_tpu_torch.apps import source_sep as ss
from nsgp_tpu_torch.convert import load_trained
from nsgp_tpu_torch.experiments import (OUT_ROOT, TRAINED_OUT, TRAINED_ROOT, add_device_arg,
                                        sync, working_dtype)
from nsgp_tpu_torch.pretrain import pipeline
from nsgp_tpu_torch.utils import metrics
from nsgp_tpu_torch.utils.audio import load_normalized, read_wav, resample, write_wav
from nsgp_tpu_torch.utils.device import resolve_device

NOTES = ("M60", "M64", "M67")
PARTS = ("C", "E", "G")
MIX_LIK = 1e-4  # ref source_sep_piano.m:57
FS = 16000
TEST_IND = (96000, 192000)  # 0-based [96001:192000] (ref :110)


def _note_model(instrument, note, kernel1, D, N, out_dir, pretrain_kwargs, dev):
    """Load the per-note model (the committed one first), or train it on the
    whole 16 kHz recording and cache it under ``out_dir``."""
    dtype = working_dtype(dev)
    fname = f"trained_{instrument}_{note}_{kernel1}.npz"
    for root in (TRAINED_ROOT, out_dir):
        path = os.path.join(root, "source_sep", fname)
        if os.path.exists(path):
            return load_trained(path, device=dev, dtype=dtype, full=True)
    y_norm, normaliser, fs = load_normalized(
        os.path.join(exps.AUDIO_ROOT, "source_sep", "training_data",
                     f"{instrument}_{note}_train.wav"), fs_target=FS)
    kw = dict(num_levels=3, steps_per_level=300)
    kw.update(pretrain_kwargs or {})
    tm = pipeline.train_gtnmf_fixed_params(torch.tensor(y_norm, dtype=dtype), D=D, N=N,
                                           kernel1=kernel1, fs=float(fs),
                                           filterbank_kwargs=kw, device=dev)
    tm = tm._replace(normaliser=normaliser)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    pipeline.save_trained(path, tm)
    return tm


def run(
    instrument="011PFNOM",
    D=16,  # ref train_source_sep.m:12
    N=3,
    kernel1="exp",
    engine="ep",
    ep_itts=10,  # ref source_sep_piano.m:87
    damping=0.025,  # ref :86
    n_samples=200,
    save_wavs=True,
    pretrain_kwargs=None,
    out_dir=TRAINED_OUT,
    device=None,
    wav_dir=os.path.join(OUT_ROOT, "wavs"),
):
    dev = resolve_device(device)
    dtype = working_dtype(dev)
    sync(dev)
    t0 = time.perf_counter()
    models, params = [], []
    for note in NOTES:
        tm = _note_model(instrument, note, kernel1, D, N, out_dir, pretrain_kwargs, dev)
        models.append(tm.model)
        params.append(tm.params)
    sync(dev)
    train_s = time.perf_counter() - t0

    # Test mixture: 16 kHz, normalized by its own variance (ref :103-112)
    test_dir = os.path.join(exps.AUDIO_ROOT, "source_sep", "test_data")
    y_mix, normaliser, _ = load_normalized(os.path.join(test_dir, f"{instrument}_mixture.wav"),
                                           fs_target=FS)
    lo, hi = TEST_IND
    y_test = torch.tensor(y_mix[lo:hi], dtype=dtype, device=dev)
    # Ground-truth parts: mixture normaliser, then /3 (ref :116-125)
    parts = []
    for p in PARTS:
        yp, fsp = read_wav(os.path.join(test_dir, f"{instrument}_{p}_part.wav"))
        yp = resample(yp, FS, fsp) / normaliser / 3.0
        parts.append(yp[lo:hi])
    parts = torch.tensor(np.stack(parts, axis=-1), dtype=dtype, device=dev)  # (T, 3)

    ek = {"ep_itts": ep_itts, "damping": (damping,), "ep_fraction": 0.75}
    if engine == "ihgp":
        ek["grid_lo"] = -7.0
        ek["parallel"] = True
        ek["chunk"] = 2048
    if engine == "ep" and dev.type == "cuda":
        # the batched kernels at BF=1: the N=9 ut9 cubature (3973 points)
        # streams in 256-point chunks; moment_chunk bounds the re-site's
        # (chunk, 3973, 48) intermediate
        ek["backend"] = "fused"
        ek["s_chunk"] = 256
        ek["moment_chunk"] = 64
    sep = lambda: ss.separate(models, params, y_test, engine=engine, true_sources=parts,
                              n_samples=n_samples, mixture_lik=MIX_LIK, device=dev, **ek)
    times = []
    for _ in range(2):  # cold, warm
        sync(dev)
        t0 = time.perf_counter()
        r = sep()
        sync(dev)
        times.append(time.perf_counter() - t0)

    src = r.sources.double().cpu().numpy()
    if save_wavs:
        os.makedirs(wav_dir, exist_ok=True)
        peak = max(np.abs(src).max(), 1e-9)
        for j, p in enumerate(PARTS):
            write_wav(os.path.join(wav_dir, f"{instrument}_{p}_est.wav"),
                      src[:, j] / peak * 0.9, FS)

    # mixture-as-estimate baseline: the trivial "no separation" predictor
    part = lambda j: parts[:, j]
    return {
        "experiment": "source_sep",
        "protocol": "reference (16 kHz, whole-file-trained notes, "
                    "test_ind 96001:192000, parts/3)",
        "instrument": instrument,
        "engine": engine,
        "ep_itts": ep_itts,
        "damping": damping,
        "D_per_source": D,
        "N_per_source": N,
        "snr_db": [float(s) for s in r.snr],
        "snr_baseline_db": [float(metrics.snr_db(part(j), y_test)) for j in range(3)],
        "log_spec_snr_db": [float(metrics.log_spec_snr_db(part(j), r.sources[:, j]))
                            for j in range(3)],
        "log_spec_snr_baseline_db": [float(metrics.log_spec_snr_db(part(j), y_test))
                                     for j in range(3)],
        "pretrain_seconds": round(train_s, 2),
        "separate_seconds_cold": round(times[0], 2),
        "separate_seconds_warm": round(times[1], 2),
    }


def main():
    import argparse

    ap = argparse.ArgumentParser()
    add_device_arg(ap)
    ap.add_argument("--instrument", default="011PFNOM")
    ap.add_argument("--engine", default="ep", choices=["ep", "ihgp", "giekf"])
    ap.add_argument("--D", type=int, default=16)
    ap.add_argument("--N", type=int, default=3)
    ap.add_argument("--itts", type=int, default=10)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    res = run(instrument=args.instrument, engine=args.engine, D=args.D, N=args.N,
              ep_itts=args.itts, device=args.device)
    out = args.out or os.path.join(OUT_ROOT, f"source_sep_{args.instrument}_{args.engine}.json")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(res, f, indent=2)
    print(json.dumps(res, indent=2))


if __name__ == "__main__":
    main()
