"""Hyperparameter-learning experiment on real audio.

Port of ``nsgp_tpu/experiments/train_hyperopt.py``: the reference's fminunc
stage (train_model.m:222-246) and its gaps-training variant
(train_GTFNMF_gaps.m).  Starting from the fixed-params initialization,
optimize the EP marginal-likelihood energy over the constrained
hyperparameter groups the reference tunes (tune_hypers = [lik, -, -, -,
var_s, len_s, W], train_GTFNMF_gaps.m:130) with the reference's box
constraints (:117-122), then show the learned hypers against the init on
the downstream missing-data gap SNR.

Exact autograd gradients of the ADF energy (ep_itts_train=1) and Adam
replace fminunc's finite differences; see the JAX module for why the
single-sweep energy.

CLI: python -m nsgp_tpu_torch.experiments.train_hyperopt \\
        [--files speech0_female speech1_male] [--gaps] [--device cuda|cpu]
Writes results/torch/train_hyperopt.json.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from nsgp_tpu_torch.apps import missing_data as md
from nsgp_tpu_torch.experiments import (OUT_ROOT, add_device_arg, protocol, sync, train_corpus,
                                        with_lik)
from nsgp_tpu_torch.experiments.missing_data import engine_config
from nsgp_tpu_torch.inference import learn
from nsgp_tpu_torch.models.gtnmf import GTNMFParams
from nsgp_tpu_torch.utils.device import resolve_device

# Reference constraint ranges and tune mask (train_model.m:110-127:
# tune_hypers = [0, 0, 1, 0, 1, 1, 1] — len_fast, var_slow, len_slow, W)
SPECS = {
    "lik": "fixed",  # w_lik_train = 1e-3, not tuned (train_model.m:42,126)
    "sub_var": "fixed",
    "sub_len": (100.0, 2000.0),  # range_len_fast
    "omega": "fixed",
    "mod_var": (1.0, 10.0),
    "mod_len": (200.0, 5000.0),
    "W": (0.0, 1.5),
}


def train_gap_mask(T: int, gap_len: int = 100, spacing: int = 1000):
    """Artificial training gaps (train_GTFNMF_gaps.m:169-177): length-100
    gaps centered every 1000 samples, clear of the edges.  A CPU tensor."""
    mask = np.ones(T, bool)
    half = int(np.ceil(gap_len / 2))
    for pos in range(500, T - 500 + 1, spacing):
        mask[max(pos - half, 0): pos + half + 1] = False
    return torch.tensor(mask)


def _clip_into(params: GTNMFParams) -> GTNMFParams:
    """Clip the init into the constraint interiors (ref :134-139)."""
    def c(x, lo, hi):
        return torch.clamp(x, lo + 1e-3 * (hi - lo), hi - 1e-3 * (hi - lo))

    return GTNMFParams(lik=params.lik, sub_var=params.sub_var,
                       sub_len=c(params.sub_len, *SPECS["sub_len"]), omega=params.omega,
                       mod_var=c(params.mod_var, *SPECS["mod_var"]),
                       mod_len=c(params.mod_len, *SPECS["mod_len"]), W=c(params.W, *SPECS["W"]))


def run_file(
    corpus: str,
    name: str,
    kernel1="exp",
    steps=150,
    learning_rate=1e-2,
    ep_itts_train=1,  # ref train_model.m:60 (ADF energy)
    w_lik_train=1e-3,  # ref :42
    gaps_train=False,
    eval_itts=20,
    device=None,
):
    """Reference-protocol hyperopt: start from the trained fixed-params
    artifact, optimize the ADF energy on yTrain = y_norm[:16000]
    (train_model.m:69 train_duration), then score the reference
    missing-data gap fill on the whole y_norm, learned vs init."""
    dev = resolve_device(device)
    tm, y_norm = train_corpus.load_corpus_model(corpus, name, kernel1, device=dev)
    dt = tm.params.W.dtype
    T = len(y_norm)
    n_train = min(16000, T)
    y_train = torch.tensor(y_norm[:n_train], dtype=dt, device=dev)
    init = _clip_into(with_lik(tm.params, w_lik_train))
    mask = train_gap_mask(n_train) if gaps_train else None

    sync(dev)
    t0 = time.perf_counter()
    fit = learn.fit_hyperparams(tm.model, init, y_train, mask=mask, engine="ep", specs=SPECS,
                                steps=steps, learning_rate=learning_rate, device=dev,
                                ep_itts=ep_itts_train)
    sync(dev)
    opt_s = time.perf_counter() - t0
    energies = fit.energies.double().cpu().numpy()

    # Downstream evaluation: the reference missing-data protocol on the
    # whole trained signal, init vs learned hypers.
    gmask = torch.tensor(protocol.reference_gap_mask(name, T), device=dev)
    y = torch.tensor(y_norm, dtype=dt, device=dev)
    ek = engine_config("ep", eval_itts, device=dev)
    fill = lambda p: md.fill_gaps(tm.model, with_lik(p, protocol.W_LIK_MISSING), y, gmask,
                                  engine="ep", n_samples=200, device=dev, **ek)
    r_init, r_opt = fill(init), fill(fit.params)

    return {
        "file": name,
        "T": T,
        "D": tm.model.D,
        "N": tm.model.N,
        "kernel1": kernel1,
        "gaps_train": bool(gaps_train),
        "steps": steps,
        "ep_itts_train": ep_itts_train,
        "opt_seconds": round(opt_s, 3),
        "energy_first": float(energies[0]),
        "energy_last": float(energies[-1]),
        "energy_trace": [float(e) for e in energies[:: max(1, steps // 20)]],
        "snr_gaps_init_db": float(r_init.snr_gaps),
        "snr_gaps_learned_db": float(r_opt.snr_gaps),
        "learned": {
            "lik": float(fit.params.lik),
            "mod_var": fit.params.mod_var.double().cpu().tolist(),
            "mod_len": fit.params.mod_len.double().cpu().tolist(),
            "W_mean": float(fit.params.W.mean()),
        },
    }


def run(files=("speech0_female", "speech1_male"), corpus="speech", gaps_train=False, **kwargs):
    out = {
        "experiment": "train_hyperopt" + ("_gaps" if gaps_train else ""),
        "tuned_groups": [g for g, s in SPECS.items() if s != "fixed"],
        "files": [],
    }
    for name in files:
        out["files"].append(run_file(corpus, name, gaps_train=gaps_train, **kwargs))
    out["aggregate"] = {
        "mean_energy_drop": float(
            np.mean([f["energy_first"] - f["energy_last"] for f in out["files"]])),
        "mean_snr_gain_db": float(
            np.mean([f["snr_gaps_learned_db"] - f["snr_gaps_init_db"] for f in out["files"]])),
    }
    return out


def main():
    import argparse

    ap = argparse.ArgumentParser()
    add_device_arg(ap)
    ap.add_argument("--files", nargs="+", default=["speech0_female", "speech1_male"])
    ap.add_argument("--corpus", default="speech")
    ap.add_argument("--gaps", action="store_true",
                    help="train with artificial gaps (train_GTFNMF_gaps.m)")
    ap.add_argument("--steps", type=int, default=80)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if args.out is None:
        args.out = os.path.join(OUT_ROOT,
                                "train_hyperopt%s.json" % ("_gaps" if args.gaps else ""))
    res = run(files=tuple(args.files), corpus=args.corpus, gaps_train=args.gaps,
              steps=args.steps, device=args.device)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=2)
    print(json.dumps(res["aggregate"], indent=2))


if __name__ == "__main__":
    main()
