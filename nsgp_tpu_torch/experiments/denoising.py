"""Speech denoising noise-level sweep under the reference protocol
(ref noise_reduction_speech.m).

Port of ``nsgp_tpu/experiments/denoising.py``.  Protocol: the clean signal
is the whole 16 kHz unit-variance trained signal (y_norm); white noise at
the reference's 5 variances is added (yTest = y_norm + sqrt(v) randn, :63);
w_lik is set to the true level v (:80); EP runs 30 sweeps at fraction 0.75,
damping 0.1 (:21,:28-29); reconstruction is 200 MC samples through the
sqrt-link (:139-144).

Baselines and metrics beyond the reference's SNR+RMSE: an FFT Wiener
filter from the trained artifact's own stage-1 stationary fit, the
time-varying Wiener read-out (``apps.denoise.tv_wiener``) and its
stationary-floor blend arms, log-spectral SNR, STOI and fwSegSNR.

The noise of level i comes from a generator seeded with ``seed + i``, or
is given (``noise=``: standard normals, one row a level).

CLI: python -m nsgp_tpu_torch.experiments.denoising [--files speech0_female ...]
        [--device cuda|cpu]
Writes results/torch/noise_reduction_speech.json.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

from nsgp_tpu_torch.apps import denoise as dn
from nsgp_tpu_torch.experiments import OUT_ROOT, add_device_arg, protocol, sync, train_corpus
from nsgp_tpu_torch.pretrain import filterbank as fb_mod
from nsgp_tpu_torch.utils import metrics
from nsgp_tpu_torch.utils.device import resolve_device
from nsgp_tpu_torch.utils.speech_quality import fw_seg_snr
from nsgp_tpu_torch.utils.stoi import stoi


def run_file(
    corpus: str,
    name: str,
    kernel1: str = "exp",
    ep_itts: int = 30,  # ref noise_reduction_speech.m:21
    engine: str = "ep",
    noise_levels=protocol.NOISE_LEVELS,
    seed: int = 0,
    pad_T: int | None = None,
    n_samples: int = 200,  # ref :113 (s = 200)
    stat_floor: float = 1.0,  # kappa of the headline read-out (tv_wiener's
    # stat_floor; 1.0 = never suppress harder than the stationary Wiener)
    blend_arms: tuple = (0.0, 0.25, 0.5, 0.75, 1.0),  # recorded kappa sweep
    device=None,
    noise=None,  # (len(noise_levels), T) standard normals; default drawn
):
    dev = resolve_device(device)
    tm, y_norm = train_corpus.load_corpus_model(corpus, name, kernel1, device=dev)
    dt = tm.params.W.dtype
    T = len(y_norm)
    Tp = pad_T or T
    fs = int(tm.fs)
    y_clean = torch.tensor(y_norm, dtype=dt, device=dev)
    host = lambda x: x.detach().double().cpu().numpy()

    # Wiener baseline from the trained artifact's own stationary fit (no
    # refit); the no-modulator counterpart of GT-NMF.
    wfit = tm.fit
    if wfit is None:
        raise ValueError(f"{name} artifact predates the stored stage-1 fit — re-run "
                         "nsgp_tpu_torch.experiments.train_corpus for this file")
    w_len = wfit.lengthscales(kernel1)
    w_noise = float(torch.clamp_min(wfit.noise, 1e-6))
    S_stat = dn.stationary_spectrum(kernel1, wfit.sigma2, w_len, wfit.omega, dtype=dt)

    rows = []
    for i, v in enumerate(noise_levels):
        xi = (torch.randn(T, generator=torch.Generator().manual_seed(seed + i), dtype=dt)
              if noise is None else torch.as_tensor(noise[i], dtype=dt))
        y_noisy = y_clean + float(np.sqrt(v)) * xi.to(dev)
        ypad = torch.full((Tp,), float("nan"), dtype=dt, device=dev)
        ypad[:T] = y_noisy
        ek = {"ep_itts": ep_itts, "ep_fraction": 0.75, "damping": (0.1,)}
        if engine == "ep" and dev.type == "cuda":
            ek["backend"] = "fused"  # the kernels, as missing_data.engine_config
        if engine == "ihgp":
            ek["grid_lo"] = -7.0
            if ep_itts >= 20:
                ek["damping"] = (0.01,)  # ref noise_reduction_speech.m:30-32
        if engine == "giekf":
            ek = {"g_iter": ep_itts, "l_iter": 1}
        times = []
        for _ in range(2):  # cold / warm
            sync(dev)
            t0 = time.perf_counter()
            r = dn.denoise(tm.model, tm.params, ypad, float(v), y_clean=None, engine=engine,
                           n_samples=n_samples, device=dev, **ek)
            sync(dev)
            times.append(time.perf_counter() - t0)
        y_mc = r.y_hat[:T]
        # Headline output: time-varying Wiener from the posterior modulator
        # envelopes; the reference's MC resynthesis is kept as *_mc columns.
        Eft = r.result.Eft[:T]
        wiener = lambda kap: dn.tv_wiener(tm.model, tm.params, Eft, y_noisy, float(v),
                                          stat_spec=S_stat, stat_floor=kap)
        y_hat = wiener(stat_floor)
        clean = host(y_clean)
        st = lambda est: round(stoi(clean, host(est), fs), 4)
        fw = lambda est: round(float(fw_seg_snr(y_clean, est, fs)), 3)
        ls = lambda est: float(metrics.log_spec_snr_db(y_clean, est))
        snr = lambda est: float(metrics.snr_db(y_clean, est))
        blend = {}
        for kap in blend_arms:
            yk = wiener(kap)
            blend[str(kap)] = {"snr_db": snr(yk), "stoi": st(yk), "log_spec_snr_db": ls(yk),
                               "fwsegsnr_db": fw(yk)}
        Zw = fb_mod.fft_filterbank(wfit.sigma2, w_len, wfit.omega, y_noisy, kernel=kernel1,
                                   noise=v + w_noise, device=dev)
        y_wiener = Zw.real.sum(-1)
        rows.append({
            "noise_var": v,
            "snr_in_db": snr(y_noisy),
            "snr_out_db": snr(y_hat),
            "snr_mc_db": snr(y_mc),
            "snr_wiener_db": snr(y_wiener),
            "rmse": float(metrics.rmse(y_clean, y_hat)),
            "log_spec_snr_out_db": ls(y_hat),
            "log_spec_snr_mc_db": ls(y_mc),
            "log_spec_snr_wiener_db": ls(y_wiener),
            "stoi_in": st(y_noisy),
            "stoi_out": st(y_hat),
            "stoi_mc": st(y_mc),
            "stoi_wiener": st(y_wiener),
            # PESQ stand-in (the reference ships pesq.p, un-portable p-code):
            # fwSegSNR, Hu & Loizou 2008 — see utils.speech_quality
            "fwsegsnr_in_db": fw(y_noisy),
            "fwsegsnr_out_db": fw(y_hat),
            "fwsegsnr_mc_db": fw(y_mc),
            "fwsegsnr_wiener_db": fw(y_wiener),
            "seconds_cold": round(times[0], 3),
            "seconds_warm": round(times[1], 3),
            "stat_floor": stat_floor,
            "blend": blend,
        })
        print({"file": name, "kernel": kernel1, **rows[-1]}, file=sys.stderr, flush=True)
    return {"file": name, "T": T, "pad_T": Tp, "fs": fs,
            "D": tm.model.D, "N": tm.model.N, "kernel1": kernel1,
            "engine": engine, "ep_itts": ep_itts, "rows": rows}


def run(files=("speech0_female", "speech1_male"), corpus="speech", kernels=("exp",),
        engine="ep", ep_itts=30, n_samples=200, stat_floor=1.0, device=None):
    pad_T = None
    if len(files) > 1:
        from nsgp_tpu_torch.experiments.missing_data import _pad_len

        pad_T = _pad_len(corpus, files)
    out = {"experiment": "noise_reduction_speech",
           "protocol": "reference (whole y_norm @16kHz, w_lik = true v)",
           "noise_levels": protocol.NOISE_LEVELS, "files": []}
    for name in files:
        for kernel in kernels:
            out["files"].append(run_file(
                corpus, name, kernel1=kernel, ep_itts=ep_itts, engine=engine, pad_T=pad_T,
                n_samples=n_samples, stat_floor=stat_floor, device=device))
    # per-level aggregate over files (ref noise_reduction_results.m:23-63)
    agg = {}
    for f in out["files"]:
        for row in f["rows"]:
            agg.setdefault((f["kernel1"], row["noise_var"]), []).append(row)
    mean = lambda rows, k: float(np.mean([r[k] for r in rows]))
    out["aggregate"] = {
        f"{k}_{v}": {
            "mean_snr_out_db": mean(rows, "snr_out_db"),
            "mean_snr_wiener_db": mean(rows, "snr_wiener_db"),
            "mean_log_spec_snr_out_db": mean(rows, "log_spec_snr_out_db"),
            "mean_log_spec_snr_wiener_db": mean(rows, "log_spec_snr_wiener_db"),
            "mean_stoi_out": mean(rows, "stoi_out"),
            "mean_stoi_in": mean(rows, "stoi_in"),
            "mean_fwsegsnr_out_db": mean(rows, "fwsegsnr_out_db"),
            "mean_fwsegsnr_in_db": mean(rows, "fwsegsnr_in_db"),
            "mean_fwsegsnr_wiener_db": mean(rows, "fwsegsnr_wiener_db"),
        }
        for (k, v), rows in agg.items()
    }
    return out


def main():
    import argparse

    ap = argparse.ArgumentParser()
    add_device_arg(ap)
    ap.add_argument("--files", nargs="+", default=["speech0_female", "speech1_male"])
    ap.add_argument("--kernels", nargs="+", default=["exp"], choices=["exp", "matern32"])
    ap.add_argument("--engine", default="ep", choices=["ep", "ihgp", "giekf"])
    ap.add_argument("--itts", type=int, default=30)
    ap.add_argument("--n-samples", type=int, default=200)
    ap.add_argument("--out", default=os.path.join(OUT_ROOT, "noise_reduction_speech.json"))
    args = ap.parse_args()
    res = run(files=tuple(args.files), kernels=tuple(args.kernels), engine=args.engine,
              ep_itts=args.itts, n_samples=args.n_samples, device=args.device)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=2)
    print(json.dumps(res["aggregate"], indent=2))


if __name__ == "__main__":
    main()
