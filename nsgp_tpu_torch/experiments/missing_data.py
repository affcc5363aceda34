"""Missing-data experiment under the reference protocol
(ref missing_data_music.m / test_missing_data.m).

Port of ``nsgp_tpu/experiments/missing_data.py``.  Protocol (see
``protocol``):
- the test signal IS the whole 16 kHz unit-variance trained signal
  (``yTest = y_norm``, missing_data_music.m:86);
- 6 gaps of 321 samples at hand-picked non-silent positions per file;
- w_lik = 1e-4; EP fraction 0.75, damping 0.1 (IHGP@20: 0.0025);
- GIEKF runs ep_itts global passes with 1 inner iteration;
- reconstruction: 200 MC samples through the link (:150-175);
- per-file score: SNR + RMSE over the concatenated gap samples (:277-278),
  corpus aggregate: mean over files with per-file SNR floored at 0
  (missing_data_music_results.m:26 ``mean(max(snr_y,0))``).

Signals are zero-padded (mask False) to one per-corpus length, as in the
JAX package; timings are split cold (first call) / warm, with the card
synchronised around each call.  The batched grid (the default) runs one
batched inference per (kernel, engine, itts) over up to ``BATCH_CAP`` files
(``inference.batched``: on the card EP runs the batched ADF kernel K4, then
K1/K2 over all files' channels; GIEKF one loop over T for all files).

CLI: python -m nsgp_tpu_torch.experiments.missing_data --corpus music \\
        [--kernels exp matern32] [--engines ep ihgp giekf] [--itts 1 20]
        [--device cuda|cpu]
Writes results/torch/missing_data_<corpus>.json.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

from nsgp_tpu_torch import experiments as exps
from nsgp_tpu_torch.apps import missing_data as md
from nsgp_tpu_torch.experiments import (OUT_ROOT, add_device_arg, protocol, sync, train_corpus,
                                        with_lik)
from nsgp_tpu_torch.models.gtnmf import stack_params
from nsgp_tpu_torch.utils.device import resolve_device

# What a failed arm may raise without ending the grid: the card running out
# of memory or a lost file.  The row is recorded with NaN metrics and the
# error; programming errors propagate.
_ARM_ERRORS = (torch.cuda.OutOfMemoryError, OSError, TimeoutError)


def _pad_len(corpus: str, files) -> int:
    """One padded length per corpus: max 16 kHz length, rounded up to 2048."""
    import wave

    mx = 0
    for name in files:
        with wave.open(os.path.join(exps.AUDIO_ROOT, corpus, f"{name}.wav")) as w:
            n16 = int(np.ceil(w.getnframes() * protocol.FS_REFERENCE / w.getframerate()))
        mx = max(mx, n16)
    return int(-(-mx // 2048) * 2048)


def engine_config(engine: str, itts: int, extra=None, device=None) -> dict:
    """The reference's per-engine inference settings
    (missing_data_music.m:23-26,119-129), and on the card the fused EP
    kernels (the JAX package's ``backend="pallas"`` off the CPU).

    DOCUMENTED DEVIATION (the JAX package's) — IHGP multi-sweep damping: the
    reference drops damping to 0.0025 at 20 sweeps (:25-26), which leaves
    the EP sites under-converged; the tuned (0.1 ADF, 0.025 re-site)
    schedule closes the gap to full EP.  ``ihgp`` is the tuned arm with
    energy-based sweep selection (``keep_best``), ``ihgp_ref`` the
    reference's flat 0.0025 and raw trajectory.
    """
    ek = {}
    if engine == "ep":
        ek = {"ep_itts": itts, "ep_fraction": 0.75, "damping": (0.1,)}
        if resolve_device(device).type == "cuda":
            ek["backend"] = "fused"
    if engine.startswith("ihgp"):
        damping = (0.1,) if itts == 1 else (
            (0.0025,) if engine == "ihgp_ref" else (0.1, 0.025))
        ek = {"ep_itts": itts, "ep_fraction": 0.75, "damping": damping,
              "grid_lo": -7.0,  # realized R = lik/ttau with lik=1e-4
              # blocked two-level steady scans for sweeps >= 2
              "parallel": True, "chunk": 2048,
              "keep_best": engine != "ihgp_ref"}
    if engine == "giekf":
        ek = {"g_iter": itts, "l_iter": 1}
    ek.update(extra or {})
    return ek


def _padded(name: str, y_norm, pad_T: int):
    """(y, mask, metric gaps) of one file, zero-padded (unobserved, not
    scored) to ``pad_T``."""
    T = len(y_norm)
    mask_np = protocol.reference_gap_mask(name, T)
    y = np.zeros((pad_T,), np.float64)
    y[:T] = y_norm
    mask = np.zeros((pad_T,), bool)
    mask[:T] = mask_np
    gaps = np.zeros((pad_T,), bool)
    gaps[:T] = ~mask_np
    return y, mask, gaps


def run_file(
    corpus: str,
    name: str,
    kernel1: str = "exp",
    engines=("ep", "ihgp"),
    ep_itts=(1, 20),
    pad_T: int | None = None,
    n_samples: int = 200,  # ref missing_data_music.m:150 (s = 200)
    engine_extra=None,
    seen_configs: set | None = None,  # with a uniform pad_T only the first file
    # per (engine, itts, kernel) gets a cold call; later files run warm only
    device=None,
):
    dev = resolve_device(device)
    tm, y_norm = train_corpus.load_corpus_model(corpus, name, kernel1, device=dev)
    params = with_lik(tm.params, protocol.W_LIK_MISSING)
    T = len(y_norm)
    Tp = pad_T or T
    y, mask, gaps = _padded(name, y_norm, Tp)
    y = torch.tensor(y, dtype=params.W.dtype, device=dev)
    mask_t, gaps_t = (torch.tensor(x, device=dev) for x in (mask, gaps))

    rows = []
    for eng in engines:
        for itts in ep_itts:
            ek = engine_config(eng, itts, engine_extra, dev)
            ckey = (eng, itts, kernel1, Tp)
            fresh = seen_configs is None or ckey not in seen_configs
            if seen_configs is not None:
                seen_configs.add(ckey)
            times = []
            try:
                for _ in range(2 if fresh else 1):  # cold, warm
                    sync(dev)
                    t0 = time.perf_counter()
                    r = md.fill_gaps(tm.model, params, y, mask_t, engine=eng.split("_")[0],
                                     n_samples=n_samples, metric_gaps=gaps_t, device=dev, **ek)
                    sync(dev)
                    times.append(time.perf_counter() - t0)
                rows.append({
                    "engine": eng,
                    "ep_itts": itts,
                    "rmse_gaps": float(r.rmse_gaps),
                    "snr_gaps_db": float(r.snr_gaps),
                    "seconds_cold": round(times[0], 3) if fresh else None,
                    "seconds_warm": round(times[-1], 3),
                })
            except _ARM_ERRORS as e:
                rows.append({
                    "engine": eng, "ep_itts": itts,
                    "rmse_gaps": float("nan"), "snr_gaps_db": float("nan"),
                    "seconds_cold": None, "seconds_warm": None,
                    "error": f"{type(e).__name__}: {e}"[:300],
                })
                if seen_configs is not None:
                    seen_configs.discard(ckey)
            print({"file": name, **rows[-1]}, file=sys.stderr, flush=True)
    return {"file": name, "T": T, "pad_T": Tp, "D": tm.model.D,
            "N": tm.model.N, "kernel1": kernel1,
            "w_lik": protocol.W_LIK_MISSING, "rows": rows}


# Per-engine file-batch cap on the card (80 GB).  The JAX package's caps
# (EP 6: 128 TPU lanes / (D+N); GIEKF 2: a 16 GB chip) do not bind here: K4
# runs a CTA per file, so EP takes whole corpora; GIEKF holds about five
# (T, m, m) trajectories a file (about 3.5 GB at music length, m = 57, in
# float32), so 8 files take under 30 GB.
BATCH_CAP = {"ep": 16, "ihgp": 16, "ihgp_ref": 16, "giekf": 8}


def run_batched(corpus="music", files=None, kernels=("exp",), engines=("ep", "ihgp"),
                ep_itts=(1, 20), n_samples=200, engine_extra=None, device=None):
    """Batched grid: one batched inference per (kernel, engine, itts) over up
    to ``BATCH_CAP`` corpus files at once, replacing the reference's serial
    file loop (missing_data_music.m:43-133).

    Emits the same JSON schema as run(); per-row ``seconds_warm`` is the
    warm batch wall-clock divided by the batch size (per-file share) and
    ``batch_size``/``batch_seconds_warm`` record the batch-level numbers.
    The first batch of each arm runs twice (cold, then warm).
    """
    dev = resolve_device(device)
    files = tuple(files) if files else protocol.CORPUS_FILES[corpus]
    pad_T = _pad_len(corpus, files)
    out = {"experiment": f"missing_data_{corpus}",
           "protocol": "reference (whole y_norm @16kHz, 6x321-sample gaps)",
           "gap_samples": 2 * protocol.GAP_HALF + 1,
           "mode": "batched", "files": []}
    t_grid = time.perf_counter()
    per_file_rows = {name: {} for name in files}
    meta = {}
    for kernel in kernels:
        # Load all artifacts once per kernel arm.
        tms, ys, masks, gaps = [], [], [], []
        for name in files:
            tm, y_norm = train_corpus.load_corpus_model(corpus, name, kernel, device=dev)
            y, m, g = _padded(name, y_norm, pad_T)
            tms.append(tm)
            ys.append(y)
            masks.append(m)
            gaps.append(g)
            meta[(name, kernel)] = {"T": len(y_norm), "D": tm.model.D, "N": tm.model.N}
        model = tms[0].model
        paramsB_all = stack_params([with_lik(tm.params, protocol.W_LIK_MISSING) for tm in tms])
        yB_all = torch.tensor(np.stack(ys), dtype=paramsB_all.W.dtype, device=dev)
        maskB_all = torch.tensor(np.stack(masks), device=dev)
        gapsB_all = torch.tensor(np.stack(gaps), device=dev)
        del tms

        for eng in engines:
            cap = BATCH_CAP.get(eng, 8)
            for itts in ep_itts:
                ek = engine_config(eng, itts, engine_extra, dev)
                times, rows_eng = [], {}
                try:
                    for s in range(0, len(files), cap):
                        ix = list(range(s, min(s + cap, len(files))))
                        bsz = len(ix)
                        pB = stack_params([paramsB_all.select(i) for i in ix])
                        for _ in range(2 if s == 0 else 1):  # cold, warm
                            sync(dev)
                            t0 = time.perf_counter()
                            r = md.fill_gaps_batch(
                                model, pB, yB_all[ix], maskB_all[ix], engine=eng.split("_")[0],
                                n_samples=n_samples, metric_gapsB=gapsB_all[ix], device=dev,
                                **ek)
                            sync(dev)
                            times.append(time.perf_counter() - t0)
                        rmse_b = r.rmse_gaps.double().cpu().numpy()
                        snr_b = r.snr_gaps.double().cpu().numpy()
                        del r  # release the batch's device memory before the next
                        for i, name in enumerate(files[s:s + bsz]):
                            rows_eng[name] = {
                                "engine": eng, "ep_itts": itts,
                                "rmse_gaps": float(rmse_b[i]),
                                "snr_gaps_db": float(snr_b[i]),
                                "seconds_cold": round(times[0], 3) if s == 0 else None,
                                "seconds_warm": round(times[-1] / bsz, 4),
                                "batch_size": bsz,
                                "batch_seconds_warm": round(times[-1], 3),
                            }
                except _ARM_ERRORS as e:
                    for name in files:
                        rows_eng.setdefault(name, {
                            "engine": eng, "ep_itts": itts,
                            "rmse_gaps": float("nan"), "snr_gaps_db": float("nan"),
                            "seconds_cold": None, "seconds_warm": None,
                            "error": f"{type(e).__name__}: {e}"[:300],
                        })
                for name in files:
                    per_file_rows[name].setdefault(kernel, []).append(rows_eng[name])
                    print({"file": name, "kernel": kernel, **rows_eng[name]},
                          file=sys.stderr, flush=True)
    for name in files:
        for kernel in kernels:
            out["files"].append({
                "file": name, "kernel1": kernel, "pad_T": pad_T,
                "w_lik": protocol.W_LIK_MISSING,
                **meta[(name, kernel)],
                "rows": per_file_rows[name][kernel],
            })
    out["grid_wall_seconds"] = round(time.perf_counter() - t_grid, 1)
    _aggregate(out)
    return out


def _aggregate(out):
    """Per-arm corpus aggregate (ref missing_data_music_results.m:26-37:
    per-file SNR floored at 0 before the mean).  A row counts as non-finite
    if either metric is; it is left out of the means and counted."""
    agg = {}
    for f in out["files"]:
        for row in f["rows"]:
            key = f"{f['kernel1']}_{row['engine']}_itts{row['ep_itts']}"
            bad = not (np.isfinite(row["snr_gaps_db"]) and np.isfinite(row["rmse_gaps"]))
            agg.setdefault(key, []).append(
                (np.nan, np.nan) if bad else (max(row["snr_gaps_db"], 0.0), row["rmse_gaps"]))
    out["aggregate"] = {
        k: {"mean_snr_gaps_db": float(np.nanmean([a for a, _ in v])),
            "mean_rmse_gaps": float(np.nanmean([b for _, b in v])),
            "n_nonfinite": int(sum(np.isnan(a) for a, _ in v))}
        for k, v in agg.items()
    }


def run(corpus="music", files=None, kernels=("exp",), engines=("ep", "ihgp"),
        ep_itts=(1, 20), n_samples=200, engine_extra=None, prior=None, device=None):
    """Serial grid.  ``prior``: a previous (possibly truncated) result dict —
    (file, kernel) entries whose rows are all error-free are reused, the
    rest rerun."""
    files = tuple(files) if files else protocol.CORPUS_FILES[corpus]
    pad_T = _pad_len(corpus, files)
    done = {}
    for f in (prior or {}).get("files", []):
        if not any("error" in row for row in f["rows"]):
            done[(f["file"], f["kernel1"])] = f
    out = {"experiment": f"missing_data_{corpus}",
           "protocol": "reference (whole y_norm @16kHz, 6x321-sample gaps)",
           "gap_samples": 2 * protocol.GAP_HALF + 1,
           "files": []}
    seen: set = set()
    for name in files:
        for kernel in kernels:
            if (name, kernel) in done:
                out["files"].append(done[(name, kernel)])
                continue
            t0 = time.perf_counter()
            out["files"].append(run_file(
                corpus, name, kernel1=kernel, engines=engines, ep_itts=ep_itts, pad_T=pad_T,
                n_samples=n_samples, engine_extra=engine_extra, seen_configs=seen,
                device=device))
            print(f"[missing_data] {name}/{kernel}: {time.perf_counter() - t0:.1f}s",
                  file=sys.stderr, flush=True)
    _aggregate(out)
    return out


def main():
    import argparse

    ap = argparse.ArgumentParser()
    add_device_arg(ap)
    ap.add_argument("--files", nargs="+", default=None)
    ap.add_argument("--corpus", default="music", choices=["music", "speech"])
    ap.add_argument("--kernels", nargs="+", default=["exp"], choices=["exp", "matern32"])
    ap.add_argument("--engines", nargs="+", default=["ep", "ihgp"],
                    choices=["ep", "ihgp", "ihgp_ref", "giekf"])
    ap.add_argument("--itts", nargs="+", type=int, default=[1, 20])
    ap.add_argument("--n-samples", type=int, default=200)
    ap.add_argument("--resume", action="store_true",
                    help="reuse error-free (file, kernel) entries from the existing --out "
                         "file; rerun the rest (serial mode)")
    ap.add_argument("--serial", action="store_true",
                    help="per-file serial grid instead of the batched multi-file default")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if args.out is None:
        args.out = os.path.join(OUT_ROOT, f"missing_data_{args.corpus}.json")
    kw = dict(corpus=args.corpus, files=args.files, kernels=tuple(args.kernels),
              engines=tuple(args.engines), ep_itts=tuple(args.itts),
              n_samples=args.n_samples, device=args.device)
    if args.serial:
        prior = None
        if args.resume and os.path.exists(args.out):
            with open(args.out) as f:
                prior = json.load(f)
        res = run(prior=prior, **kw)
    else:
        res = run_batched(**kw)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=2)
    print(json.dumps(res["aggregate"], indent=2))


if __name__ == "__main__":
    main()
