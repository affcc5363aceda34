"""Paper-style result figures from the committed artifacts.

Port of ``nsgp_tpu/experiments/figures.py`` (the reference's figure scripts:
source_sep_results.m:60-66, noise_reduction_spectrograms.m,
missing_data_music_results.m plots): PNGs under ``results/torch/figs/``.

Each figure is a data function, which runs on the device through the
ported paths and returns numpy arrays, and a renderer, which imports
matplotlib only when it draws (so the data functions run where matplotlib
is not installed):

- ``gap_fill_<file>_<kernel>.png`` (``gap_fill_data``): clean vs EP and IHGP
  reconstructions (20 sweeps) around one reference gap;
- ``spectrograms_<file>_<kernel>.png`` (``spectrogram_data``): clean / noisy
  / GT-NMF time-varying Wiener / stationary Wiener log-spectrograms;
- ``source_sep_<instr>.png`` (``source_sep_data``): estimated vs true
  waveform segments of each separated note;
- ``aggregates.png`` (``aggregates_data``): the corpus gap-SNR aggregates per
  engine arm from the missing-data JSONs.

The random draws (the added noise, the reconstructions' Monte-Carlo draws)
are arguments with seeded ``torch.Generator`` defaults.

Design notes: Okabe & Ito (2008) colorblind-safe categorical palette
(series identity, fixed order, never cycled), perceptually-uniform 'magma'
for sequential spectrogram magnitude (single light->dark job, no rainbow),
one axis per panel, thin 1.2 px lines, recessive grid, legends on every
multi-series panel.

CLI: python -m nsgp_tpu_torch.experiments.figures [--out results/torch/figs]
        [--skip gap spec sep agg] [--device cuda|cpu]
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from nsgp_tpu_torch import experiments as exps
from nsgp_tpu_torch.experiments import OUT_ROOT, add_device_arg, protocol, train_corpus, with_lik
from nsgp_tpu_torch.utils.device import resolve_device

# Okabe-Ito (2008): published CVD-validated categorical palette.
C_CLEAN = "#555555"  # reference signal: neutral recessive gray
C_EST = "#0072B2"  # primary estimate: blue
C_ALT = "#D55E00"  # comparison arm: vermillion
C_THIRD = "#009E73"  # third series: bluish green
GRID = dict(color="#dddddd", linewidth=0.6)


def _mpl():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.rcParams.update({
        "figure.dpi": 130, "axes.grid": True, "grid.color": "#e5e5e5",
        "grid.linewidth": 0.6, "axes.spines.top": False,
        "axes.spines.right": False, "font.size": 9,
        "axes.titlesize": 10, "legend.frameon": False,
    })
    return plt


def _spec(y, fs, nwin=512, hop=128):
    T = len(y)
    nfrm = max(1, (T - nwin) // hop + 1)
    idx = np.arange(nwin)[None, :] + hop * np.arange(nfrm)[:, None]
    S = np.abs(np.fft.rfft(y[idx] * np.hanning(nwin)[None], axis=-1)) ** 2
    S = np.maximum(S, S.max() * 1e-8)
    return 10 * np.log10(S).T, nfrm * hop / fs


def _host(x) -> np.ndarray:
    return x.detach().double().cpu().numpy()


def gap_fill_data(corpus="music", name="bamboo_flute", kernel="exp", gap_index=2,
                  half_window=800, device=None, generator=None):
    """Clean vs EP and IHGP reconstructions (20 sweeps, the engines'
    missing-data settings on ``device``, 50 draws) around one reference gap.
    ``generator``: the reconstructions' draws (default seed 0 on the device
    for each engine)."""
    from nsgp_tpu_torch.apps import missing_data as md
    from nsgp_tpu_torch.experiments.missing_data import engine_config

    dev = resolve_device(device)
    tm, y_norm = train_corpus.load_corpus_model(corpus, name, kernel, device=dev)
    params = with_lik(tm.params, protocol.W_LIK_MISSING)
    T = len(y_norm)
    mask = protocol.reference_gap_mask(name, T)
    y = torch.tensor(y_norm, dtype=params.W.dtype, device=dev)
    recons = {}
    for eng, label in [("ep", "EP (20 sweeps)"), ("ihgp", "IHGP (20 sweeps)")]:
        r = md.fill_gaps(tm.model, params, y, torch.tensor(mask, device=dev), engine=eng,
                         generator=generator, n_samples=50, device=dev,
                         **engine_config(eng, 20, device=dev))
        recons[label] = _host(r.y_hat)
    center = protocol.GAP_POSITIONS[name][gap_index]
    sl = slice(max(0, center - half_window), min(T, center + half_window))
    return dict(name=name, kernel=kernel,
                t_ms=np.arange(sl.start, sl.stop) / protocol.FS_REFERENCE * 1000.0,
                clean=np.asarray(y_norm)[sl], recons={k: v[sl] for k, v in recons.items()},
                gap=~mask[sl])


def render_gap_fill(out_dir, data):
    plt = _mpl()
    t = data["t_ms"]
    fig, ax = plt.subplots(figsize=(7.2, 2.6))
    ax.plot(t, data["clean"], color=C_CLEAN, lw=1.2, label="clean")
    for (label, yh), c in zip(data["recons"].items(), (C_EST, C_ALT)):
        ax.plot(t, yh, color=c, lw=1.2, label=label)
    ax.fill_between(t, *ax.get_ylim(), where=data["gap"], color="#f2e8d5", zorder=0,
                    label="gap (unobserved)")
    ax.set_xlabel("time (ms)")
    ax.set_ylabel("amplitude")
    ax.set_title(f"missing-data reconstruction — {data['name']} ({data['kernel']}), "
                 f"321-sample gap")
    ax.legend(loc="upper right", ncol=2, fontsize=8)
    path = os.path.join(out_dir, f"gap_fill_{data['name']}_{data['kernel']}.png")
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)
    return path


def fig_gap_fill(out_dir, corpus="music", name="bamboo_flute", kernel="exp", gap_index=2,
                 half_window=800, device=None):
    """Clean vs EP/IHGP reconstructions around one reference gap."""
    return render_gap_fill(out_dir, gap_fill_data(corpus, name, kernel, gap_index, half_window,
                                                  device=device))


def spectrogram_data(name="speech2_male", kernel="exp", noise_var=0.1, ep_itts=30, device=None,
                     noise=None):
    """Clean / noisy / GT-NMF time-varying Wiener / stationary Wiener signals
    (ref noise_reduction_spectrograms.m).  ``noise``: the added standard
    normals (T,), default drawn from ``torch.Generator`` seed 0."""
    from nsgp_tpu_torch.apps import denoise as dn
    from nsgp_tpu_torch.pretrain import filterbank as fb_mod

    dev = resolve_device(device)
    tm, y_norm = train_corpus.load_corpus_model("speech", name, kernel, device=dev)
    dt = tm.params.W.dtype
    fs = int(tm.fs)
    T = len(y_norm)
    y_clean = torch.tensor(y_norm, dtype=dt, device=dev)
    xi = (torch.randn(T, generator=torch.Generator().manual_seed(0), dtype=dt)
          if noise is None else torch.as_tensor(noise, dtype=dt))
    y_noisy = y_clean + float(np.sqrt(noise_var)) * xi.to(dev)
    ek = {"ep_itts": ep_itts, "ep_fraction": 0.75, "damping": (0.1,)}
    if dev.type == "cuda":
        ek["backend"] = "fused"  # the kernels, as the denoising driver runs them
    r = dn.denoise(tm.model, tm.params, y_noisy, float(noise_var), engine="ep", n_samples=50,
                   device=dev, **ek)
    wfit = tm.fit
    S_stat = dn.stationary_spectrum(kernel, wfit.sigma2, wfit.lengthscales(kernel), wfit.omega,
                                    dtype=dt)
    # headline read-out: stationary-gain floor kappa = 1.0 (the denoising
    # driver's default)
    y_hat = dn.tv_wiener(tm.model, tm.params, r.result.Eft[:T], y_noisy, float(noise_var),
                         stat_spec=S_stat, stat_floor=1.0)
    Zw = fb_mod.fft_filterbank(wfit.sigma2, wfit.lengthscales(kernel), wfit.omega, y_noisy,
                               kernel=kernel,
                               noise=noise_var + float(torch.clamp_min(wfit.noise, 1e-6)),
                               device=dev)
    return dict(name=name, kernel=kernel, fs=fs, panels=[
        ("clean", _host(y_clean)), (f"noisy (v={noise_var})", _host(y_noisy)),
        ("GT-NMF TV-Wiener", _host(y_hat)), ("stationary Wiener", _host(Zw.real.sum(-1)))])


def render_spectrograms(out_dir, data):
    plt = _mpl()
    fs = data["fs"]
    fig, axes = plt.subplots(2, 2, figsize=(8.5, 5.2), sharex=True, sharey=True)
    vmax = None
    for ax, (title, sig) in zip(axes.ravel(), data["panels"]):
        S, dur = _spec(sig, fs)
        if vmax is None:
            vmax = S.max()
        im = ax.imshow(S, origin="lower", aspect="auto", extent=[0, dur, 0, fs / 2 / 1000.0],
                       vmin=vmax - 70, vmax=vmax, cmap="magma")
        ax.set_title(title)
        ax.grid(False)
    for ax in axes[-1]:
        ax.set_xlabel("time (s)")
    for ax in axes[:, 0]:
        ax.set_ylabel("freq (kHz)")
    fig.colorbar(im, ax=axes, shrink=0.85, label="power (dB)")
    path = os.path.join(out_dir, f"spectrograms_{data['name']}_{data['kernel']}.png")
    fig.savefig(path)
    plt.close(fig)
    return path


def fig_spectrograms(out_dir, name="speech2_male", kernel="exp", noise_var=0.1, ep_itts=30,
                     device=None):
    """Clean / noisy / denoised / Wiener spectrograms (ref
    noise_reduction_spectrograms.m)."""
    return render_spectrograms(out_dir, spectrogram_data(name, kernel, noise_var, ep_itts,
                                                         device=device))


def source_sep_data(instrument="011PFNOM", window=(48000, 52000),
                    est_dir=os.path.join("results", "wavs")):
    """Per note part, the true segment and the estimate rescaled to it, from
    the test wavs under ``AUDIO_ROOT`` and the committed estimates."""
    from nsgp_tpu_torch.experiments.source_sep import FS, PARTS, TEST_IND
    from nsgp_tpu_torch.utils.audio import load_normalized, read_wav, resample

    lo, hi = TEST_IND
    test_dir = os.path.join(exps.AUDIO_ROOT, "source_sep", "test_data")
    _, normaliser, _ = load_normalized(os.path.join(test_dir, f"{instrument}_mixture.wav"),
                                       fs_target=FS)
    a, b = window
    parts = {}
    for p in PARTS:
        yp, fsp = read_wav(os.path.join(test_dir, f"{instrument}_{p}_part.wav"))
        true_seg = (resample(yp, FS, fsp) / normaliser / 3.0)[lo:hi][a:b]
        est_seg = read_wav(os.path.join(est_dir, f"{instrument}_{p}_est.wav"))[0][a:b]
        # least-squares projection undoes the saved wav's peak normalization
        # honestly: silence in the true part stays silent
        scale = float(true_seg @ est_seg / (est_seg @ est_seg + 1e-12))
        parts[p] = (true_seg, est_seg * scale)
    return dict(instrument=instrument, t_ms=np.arange(a, b) / FS * 1000.0, parts=parts)


def render_source_sep(out_dir, data):
    plt = _mpl()
    fig, axes = plt.subplots(len(data["parts"]), 1, figsize=(7.2, 5.4), sharex=True)
    t = data["t_ms"]
    for ax, (p, (true_seg, est_seg)) in zip(axes, data["parts"].items()):
        ax.plot(t, true_seg, color=C_CLEAN, lw=1.0, label="true part")
        ax.plot(t, est_seg, color=C_EST, lw=1.0, label="estimate (rescaled)")
        ax.set_ylabel(f"note {p}")
        ax.legend(loc="upper right", fontsize=7, ncol=2)
    axes[-1].set_xlabel("time (ms)")
    axes[0].set_title(f"source separation — {data['instrument']} (IHGP mixture)")
    path = os.path.join(out_dir, f"source_sep_{data['instrument']}.png")
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)
    return path


def fig_source_sep(out_dir, instrument="011PFNOM", window=(48000, 52000)):
    """Estimated vs true per-source waveform segments from committed wavs
    (ref source_sep_results.m:60-66)."""
    return render_source_sep(out_dir, source_sep_data(instrument, window))


def aggregates_data(root="results"):
    """(corpus, aggregate) per corpus from the missing-data JSONs, the
    batched file first."""
    panels = []
    for corpus in ("music", "speech"):
        for path in (os.path.join(root, f"missing_data_{corpus}_batched.json"),
                     os.path.join(root, f"missing_data_{corpus}.json")):
            if os.path.exists(path):
                with open(path) as f:
                    panels.append((corpus, json.load(f)["aggregate"]))
                break
    return panels


def render_aggregates(out_dir, panels):
    if not panels:
        return None
    plt = _mpl()
    fig, axes = plt.subplots(1, len(panels), figsize=(4.6 * len(panels), 3.2))
    axes = np.atleast_1d(axes)
    for ax, (corpus, agg) in zip(axes, panels):
        keys = sorted(agg.keys())
        vals = [agg[k]["mean_snr_gaps_db"] for k in keys]
        colors = [C_EST if "_ep_" in k else
                  C_ALT if "ihgp_ref" not in k and "_ihgp_" in k else
                  C_THIRD if "giekf" in k else "#999999" for k in keys]
        ypos = np.arange(len(keys))
        ax.barh(ypos, vals, color=colors, height=0.62)
        ax.set_yticks(ypos, [k.replace("_itts", "@") for k in keys], fontsize=7)
        ax.set_xlabel("mean gap SNR (dB)")
        ax.set_title(f"{corpus} corpus")
        ax.invert_yaxis()
    fig.tight_layout()
    path = os.path.join(out_dir, "aggregates.png")
    fig.savefig(path)
    plt.close(fig)
    return path


def fig_aggregates(out_dir):
    """Per-arm corpus gap-SNR aggregates from the missing-data JSONs."""
    return render_aggregates(out_dir, aggregates_data())


def main():
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(OUT_ROOT, "figs"))
    ap.add_argument("--skip", nargs="*", default=[], choices=["gap", "spec", "sep", "agg"])
    add_device_arg(ap)
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)
    done = []
    if "agg" not in args.skip:
        done.append(fig_aggregates(args.out))
    if "sep" not in args.skip:
        done.append(fig_source_sep(args.out))
    if "gap" not in args.skip:
        done.append(fig_gap_fill(args.out, device=args.device))
    if "spec" not in args.skip:
        done.append(fig_spectrograms(args.out, device=args.device))
    print(json.dumps({"figures": [d for d in done if d]}))


if __name__ == "__main__":
    main()
