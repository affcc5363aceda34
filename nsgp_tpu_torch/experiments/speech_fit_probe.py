"""Per-file model-fit probe for the weak speech files.

Port of ``nsgp_tpu/experiments/speech_fit_probe.py``.  The speech
missing-data spread (0.3-4.7 dB in the JAX package's runs) traces to per-file
pretrain fit quality, not to the inference or the optimizer.  This driver
retrains the weak files with fit variations:

- ``base``    : the shipped artifact (reference recipe, D=16, 3 anneal
                levels x 400 steps);
- ``d24``     : D = 24 subbands (more spectral components for breathy /
                wideband voices);
- ``anneal``  : finer coarse-to-fine schedule (4 levels x 600 steps);
- ``d24_anneal``: both.

Selection is honest: arms are scored by EP@20 gap SNR on VALIDATION gaps
(reference gap positions shifted by +2500 samples, away from the test
gaps); only the selected arm is then evaluated on the REFERENCE test gaps
and (optionally, --promote) saved with the arm recorded in the summary
JSON.  Evaluation reads the committed arms (``results/trained/speech_probe``)
and writes ``results/torch/speech_fit_probe.json``; ``--phase train`` writes
its arms under ``results/torch/trained/speech_probe`` and ``--promote`` its
selection under ``results/torch/trained/`` (never over a committed file).

CLI: python -m nsgp_tpu_torch.experiments.speech_fit_probe --phase eval \\
        [--files speech1_male ...] [--kernel matern32] [--promote]
        [--device cuda|cpu]
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

from nsgp_tpu_torch import experiments as exps
from nsgp_tpu_torch.experiments import (OUT_ROOT, TRAINED_OUT, TRAINED_ROOT, add_device_arg,
                                        protocol, sync, train_corpus, with_lik, working_dtype)
from nsgp_tpu_torch.utils.device import resolve_device

ARMS = {
    "base": {},
    "d24": {"D": 24},
    "anneal": {"filterbank_kwargs": {"num_levels": 4, "steps_per_level": 600}},
    "d24_anneal": {"D": 24, "filterbank_kwargs": {"num_levels": 4, "steps_per_level": 600}},
}
ARMS_IN = os.path.join(TRAINED_ROOT, "speech_probe")  # the committed arms (read)
ARMS_OUT = os.path.join(TRAINED_OUT, "speech_probe")  # arms trained here (written)


def _gap_mask(name, T, shift=0):
    mask = np.ones((T,), bool)
    for c in protocol.GAP_POSITIONS[name]:
        c = min(max(c + shift, protocol.GAP_HALF + 1), T - protocol.GAP_HALF - 2)
        mask[c - protocol.GAP_HALF: c + protocol.GAP_HALF + 1] = False
    return torch.tensor(mask)


def _gap_snr(tm, y_norm, mask, device=None, generator=None):
    """EP@20 gap SNR with the missing-data settings (``engine_config``: the
    fused kernels on the card), 200 draws from ``generator`` (default seed 0
    on the device)."""
    from nsgp_tpu_torch.apps import missing_data as md
    from nsgp_tpu_torch.experiments.missing_data import engine_config

    dev = resolve_device(device)
    params = with_lik(tm.params, protocol.W_LIK_MISSING)
    r = md.fill_gaps(tm.model, params, torch.tensor(y_norm, dtype=params.W.dtype), mask,
                     engine="ep", generator=generator, n_samples=200, device=dev,
                     **engine_config("ep", 20, device=dev))
    return float(r.snr_gaps)


def train_arms(files, kernel="matern32", corpus="speech", out_dir=ARMS_OUT, device=None):
    """Phase 1: train every (file, arm) variant and save .npz (the device's
    working type, as ``train_corpus``)."""
    from nsgp_tpu_torch.pretrain import pipeline
    from nsgp_tpu_torch.utils.audio import load_normalized

    dev = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    for name in files:
        y_norm, normaliser, _ = load_normalized(
            os.path.join(exps.AUDIO_ROOT, corpus, f"{name}.wav"), fs_target=protocol.FS_REFERENCE)
        for arm, kw in ARMS.items():
            if arm == "base":
                continue
            path = os.path.join(out_dir, f"{name}_{kernel}_{arm}.npz")
            if os.path.exists(path):
                continue
            sync(dev)
            t0 = time.perf_counter()
            tm = pipeline.train_gtnmf_fixed_params(
                torch.tensor(y_norm, dtype=working_dtype(dev)), kernel1=kernel, N=3,
                fs=protocol.FS_REFERENCE, device=dev, **kw)
            pipeline.save_trained(path, tm._replace(normaliser=normaliser))
            sync(dev)
            print({"file": name, "arm": arm, "trained_s": round(time.perf_counter() - t0, 1)},
                  file=sys.stderr, flush=True)


def run(files, kernel="matern32", corpus="speech", promote=False, out_dir=ARMS_IN,
        save_path=os.path.join(OUT_ROOT, "speech_fit_probe.json"), device=None):
    """Phase 2: evaluate each trained arm on validation gaps, select per
    file, score the selection on the reference test gaps."""
    from nsgp_tpu_torch.convert import load_trained
    from nsgp_tpu_torch.experiments.missing_data import _ARM_ERRORS
    from nsgp_tpu_torch.pretrain import pipeline
    from nsgp_tpu_torch.utils.audio import load_normalized

    dev = resolve_device(device)
    out = {"experiment": "speech_fit_probe", "kernel": kernel,
           "selection": "EP@20 SNR on validation gaps (+2500 shift)", "files": []}
    for name in files:
        y_norm, _, _ = load_normalized(os.path.join(exps.AUDIO_ROOT, corpus, f"{name}.wav"),
                                       fs_target=protocol.FS_REFERENCE)
        T = len(y_norm)
        val_mask = _gap_mask(name, T, shift=2500)
        test_mask = _gap_mask(name, T, shift=0)
        row = {"file": name, "arms": {}}
        tms = {}
        for arm in ARMS:
            sync(dev)
            t0 = time.perf_counter()
            try:
                if arm == "base":
                    tm, _ = train_corpus.load_corpus_model(corpus, name, kernel, device=dev)
                else:
                    path = os.path.join(out_dir, f"{name}_{kernel}_{arm}.npz")
                    if not os.path.exists(path):
                        continue
                    tm = load_trained(path, device=dev, dtype=working_dtype(dev), full=True)
                val = _gap_snr(tm, y_norm, val_mask, dev)
                sync(dev)
                tms[arm] = tm
                row["arms"][arm] = {"val_snr_db": round(val, 3),
                                    "seconds": round(time.perf_counter() - t0, 1)}
            except _ARM_ERRORS as e:
                row["arms"][arm] = {"error": f"{type(e).__name__}: {e}"[:200]}
            print({"file": name, "arm": arm, **row["arms"].get(arm, {})}, file=sys.stderr,
                  flush=True)
        ok = {a: r["val_snr_db"] for a, r in row["arms"].items()
              if "val_snr_db" in r and np.isfinite(r["val_snr_db"])}
        best = max(ok, key=ok.get)
        row["selected"] = best
        row["test_snr_db_base"] = round(_gap_snr(tms["base"], y_norm, test_mask, dev), 3)
        row["test_snr_db_selected"] = (
            row["test_snr_db_base"] if best == "base"
            else round(_gap_snr(tms[best], y_norm, test_mask, dev), 3))
        if promote and best != "base":
            path = train_corpus.trained_path(corpus, name, kernel, TRAINED_OUT)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            pipeline.save_trained(path, tms[best])
            row["promoted"] = True
        print({"file": name, "selected": best, "test_base": row["test_snr_db_base"],
               "test_selected": row["test_snr_db_selected"]}, file=sys.stderr, flush=True)
        out["files"].append(row)
    os.makedirs(os.path.dirname(save_path), exist_ok=True)
    with open(save_path, "w") as f:
        json.dump(out, f, indent=2)
    return out


def main():
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--files", nargs="+",
                    default=["speech1_male", "speech4_male", "speech5_male", "speech7_female",
                             "speech9_female", "speech6_female", "speech0_female"])
    ap.add_argument("--kernel", default="matern32")
    ap.add_argument("--phase", choices=["train", "eval"], required=True)
    ap.add_argument("--promote", action="store_true")
    add_device_arg(ap)
    args = ap.parse_args()
    if args.phase == "train":
        train_arms(files=args.files, kernel=args.kernel, device=args.device)
    else:
        run(files=args.files, kernel=args.kernel, promote=args.promote, device=args.device)


if __name__ == "__main__":
    main()
