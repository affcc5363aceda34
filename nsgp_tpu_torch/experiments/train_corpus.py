"""Corpus pre-training driver (ref train_speech.m / train_music.m /
train_textures.m: loop corpus files x kernels {exp, matern32} through
train_GTFNMF_fixed_params, saving trained_<file>_<kernel> artifacts).

Port of ``nsgp_tpu/experiments/train_corpus.py``.  Reference protocol
(train_GTFNMF_fixed_params.m): every file is resampled to 16 kHz,
normalized to unit variance over the WHOLE file, and all pre-training
stages run on the whole normalized signal.  The downstream drivers
(missing_data, denoising, train_hyperopt) load these artifacts instead of
retraining inline; by default they read the committed ones under
``results/trained/`` (either package reads what the other writes), and
this driver writes its own under ``results/torch/trained/``.

CLI: python -m nsgp_tpu_torch.experiments.train_corpus --corpus speech \\
         [--kernels exp matern32] [--limit 3] [--device cuda|cpu]
Writes results/torch/trained/<corpus>/trained_<file>_<kernel>.npz and a
summary results/torch/train_<corpus>.json.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from nsgp_tpu_torch import experiments as exps
from nsgp_tpu_torch.convert import load_trained
from nsgp_tpu_torch.experiments import (OUT_ROOT, TRAINED_OUT, TRAINED_ROOT, add_device_arg,
                                        protocol, sync, working_dtype)
from nsgp_tpu_torch.pretrain import pipeline
from nsgp_tpu_torch.utils.audio import load_normalized
from nsgp_tpu_torch.utils.device import resolve_device


def trained_path(corpus: str, name: str, kernel: str, out_dir: str = TRAINED_ROOT) -> str:
    return os.path.join(out_dir, corpus, f"trained_{name}_{kernel}.npz")


def load_corpus_model(corpus: str, name: str, kernel: str, out_dir: str = TRAINED_ROOT,
                      device=None, dtype=None):
    """Load a trained artifact + its (regenerated) y_norm test signal.

    y_norm is deterministic given the wav + the polyphase resampler, so it
    is regenerated on load instead of being stored (the reference stores it
    inside the .mat).  Returns (TrainedModel on ``device`` in ``dtype``,
    default the device's working type; y_norm float64 numpy).
    """
    path = trained_path(corpus, name, kernel, out_dir)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{path} missing - run `python -m nsgp_tpu_torch.experiments."
            f"train_corpus --corpus {corpus} --kernels {kernel}` first"
        )
    dev = resolve_device(device)
    tm = load_trained(path, device=dev, dtype=dtype or working_dtype(dev), full=True)
    y_norm, _, _ = load_normalized(os.path.join(exps.AUDIO_ROOT, corpus, f"{name}.wav"),
                                   fs_target=int(tm.fs))
    return tm, y_norm


def run(
    corpus="speech",
    kernels=("exp", "matern32"),
    D=16,
    N=3,
    limit=None,
    out_dir=TRAINED_OUT,
    pretrain_kwargs=None,
    files=None,
    device=None,
):
    """Train per-(file, kernel) models on whole 16 kHz normalized signals."""
    dev = resolve_device(device)
    if files is None:
        files = protocol.CORPUS_FILES.get(corpus)
    if files is None:  # e.g. textures: enumerate the directory
        root = os.path.join(exps.AUDIO_ROOT, corpus)
        files = tuple(sorted(f[:-4] for f in os.listdir(root) if f.endswith(".wav")))
    if limit:
        files = files[: int(limit)]
    kw = dict(num_levels=3, steps_per_level=300)
    kw.update(pretrain_kwargs or {})
    os.makedirs(os.path.join(out_dir, corpus), exist_ok=True)

    rows = []
    for name in files:
        y_norm, normaliser, fs = load_normalized(
            os.path.join(exps.AUDIO_ROOT, corpus, f"{name}.wav"), fs_target=protocol.FS_REFERENCE)
        for kernel in kernels:
            sync(dev)
            t0 = time.perf_counter()
            tm = pipeline.train_gtnmf_fixed_params(
                torch.tensor(y_norm, dtype=working_dtype(dev)), D=D, N=N, kernel1=kernel,
                fs=float(fs), filterbank_kwargs=kw, device=dev)
            tm = tm._replace(normaliser=normaliser)
            path = trained_path(corpus, name, kernel, out_dir)
            pipeline.save_trained(path, tm)
            sync(dev)
            om = np.sort(tm.params.omega.detach().cpu().double().numpy()) * fs / (2 * np.pi)
            rows.append({
                "file": name, "kernel": kernel, "artifact": path,
                "T": int(len(y_norm)), "fs": fs,
                "omega_hz_min": round(float(om[0]), 1),
                "omega_hz_max": round(float(om[-1]), 1),
                "n_distinct_omega": int(np.sum(np.diff(om, prepend=-1.0) > 1.0)),
                "whittle_obj": round(float(tm.fit.obj), 4),
                "seconds": round(time.perf_counter() - t0, 2),
            })
            print(rows[-1], flush=True)
    return {"experiment": f"train_{corpus}", "D": D, "N": N,
            "fs": protocol.FS_REFERENCE, "protocol": "whole-file y_norm", "rows": rows}


def main():
    import argparse

    ap = argparse.ArgumentParser()
    add_device_arg(ap)
    ap.add_argument("--corpus", default="speech", choices=["speech", "music", "textures"])
    ap.add_argument("--kernels", nargs="+", default=["exp", "matern32"])
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--files", nargs="+", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    res = run(corpus=args.corpus, kernels=tuple(args.kernels), limit=args.limit,
              files=tuple(args.files) if args.files else None, device=args.device)
    out = args.out or os.path.join(OUT_ROOT, f"train_{args.corpus}.json")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(res, f, indent=2)


if __name__ == "__main__":
    main()
