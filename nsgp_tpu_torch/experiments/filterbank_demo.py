"""Stationary probabilistic filterbank demo (ref demo_stationary_filterbank.m).

Port of ``nsgp_tpu/experiments/filterbank_demo.py``.  Fits a D-component
probabilistic filterbank to real speech (staged exp -> matern32 Whittle
fit), computes the complex subband decomposition with the steady-state
Kalman filterbank, reconstructs the signal from it, and gap-fills missing
samples with the exact (slow, masked) filterbank — reporting reconstruction
SNR and gap SNR like the reference's :204-226.

CLI: python -m nsgp_tpu_torch.experiments.filterbank_demo [--file speech0_female]
        [--device cuda|cpu]
Writes results/torch/filterbank_demo.json.
"""

from __future__ import annotations

import json
import os
import time

import torch

from nsgp_tpu_torch import experiments as exps
from nsgp_tpu_torch.experiments import OUT_ROOT, add_device_arg, sync, working_dtype
from nsgp_tpu_torch.pretrain import filterbank as fbm
from nsgp_tpu_torch.pretrain import spectral
from nsgp_tpu_torch.utils import metrics
from nsgp_tpu_torch.utils.audio import read_wav
from nsgp_tpu_torch.utils.device import resolve_device


def run(file="speech0_female", D=12, kernel="matern32", seconds=0.75, gap=(6000, 200),
        fit_kwargs=None, device=None):
    dev = resolve_device(device)
    dtype = working_dtype(dev)
    path = os.path.join(exps.AUDIO_ROOT, "speech", f"{file}.wav")
    y_raw, fs = read_wav(path)
    y = torch.tensor(y_raw[: int(seconds * fs)], dtype=dtype, device=dev)
    y = y / y.std(correction=0)
    T = int(y.shape[0])

    kw = dict(num_levels=4, steps_per_level=400)
    kw.update(fit_kwargs or {})
    sync(dev)
    t0 = time.perf_counter()
    fit = spectral.fit_probstft_staged(y, D, kernel=kernel, device=dev, **kw)
    sync(dev)
    fit_s = time.perf_counter() - t0

    fb = fbm.build_filterbank(
        fit.sigma2, fit.lengthscales(kernel), fit.omega, kernel=kernel,
        # the annealed-shrinkage fit can drive the noise to ~0; the steady
        # DARE bank needs it positive
        noise=max(float(fit.noise), 1e-6), device=dev)

    # Steady (fast/IHGP) path: subband decomposition + reconstruction.
    t0 = time.perf_counter()
    r = fbm.steady_filterbank(fb, y, device=dev)
    sync(dev)
    fb_s = time.perf_counter() - t0
    y_rec = r.Z.real.sum(-1)  # sum of subband means
    snr_rec = float(metrics.snr_db(y, y_rec))

    # Exact masked path: NaN a gap and inpaint (ref's slow-Kalman gap fill).
    lo, ln = gap
    mask = torch.ones((T,), dtype=torch.bool, device=dev)
    mask[lo: lo + ln] = False
    y_gap = torch.where(mask, y, torch.full_like(y, float("nan")))
    re = fbm.exact_filterbank(fb, y_gap, device=dev)
    y_fill = re.Z.real.sum(-1)
    snr_gap = float(metrics.snr_db(y, y_fill, ~mask))

    return {
        "experiment": "filterbank_demo",
        "file": file,
        "fs": fs,
        "D": D,
        "kernel": kernel,
        "T": T,
        "fit_seconds": round(fit_s, 2),
        "filterbank_seconds": round(fb_s, 3),
        "lml": float(r.lml),
        "snr_reconstruction_db": snr_rec,
        "snr_gap_fill_db": snr_gap,
        "omega": [round(v, 4) for v in fit.omega.double().cpu().tolist()],
        "sigma2": [round(v, 5) for v in fit.sigma2.double().cpu().tolist()],
    }


def main():
    import argparse

    ap = argparse.ArgumentParser()
    add_device_arg(ap)
    ap.add_argument("--file", default="speech0_female")
    ap.add_argument("--out", default=os.path.join(OUT_ROOT, "filterbank_demo.json"))
    args = ap.parse_args()
    res = run(file=args.file, device=args.device)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=2)
    print(json.dumps(res, indent=2))


if __name__ == "__main__":
    main()
