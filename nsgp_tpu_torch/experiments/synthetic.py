"""Synthetic 3-engine comparison (ref synthetic_data_experiment.m).

Port of ``nsgp_tpu/experiments/synthetic.py``.  Samples from the GT-NMF
prior, infers at the TRUE hyperparameters with all three engines, and
reports RMSE on the reconstructed signal, the subband posteriors, and the
(linked) modulator posteriors — the reference's :242-253 table.

The weights W and the prior sample come from ``torch.Generator``s seeded
from ``seed`` (W from ``seed``, the sample from ``seed + 1``), or are given
(``W=``, ``sample=``).

CLI: python -m nsgp_tpu_torch.experiments.synthetic [--T 4000] [--seed 0]
        [--device cuda|cpu]
Writes results/torch/synthetic_comparison.json.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from nsgp_tpu_torch.experiments import OUT_ROOT, add_device_arg, sync, working_dtype
from nsgp_tpu_torch.inference import registry
from nsgp_tpu_torch.models.gtnmf import GTNMFModel, GTNMFParams, sample_prior
from nsgp_tpu_torch.ops.moments import LINKS
from nsgp_tpu_torch.utils.device import resolve_device


def toy_model(D=6, N=2, seed=0, dtype=torch.float64, device="cpu", W=None):
    """The toy model and its parameters; W uniform on [0.1, 1) from a
    generator seeded with ``seed`` unless given."""
    model = GTNMFModel(D=D, N=N, kernel1="matern32", kernel2="matern52", p_cubature=9)
    if W is None:
        gen = torch.Generator().manual_seed(seed)
        W = 0.1 + 0.9 * torch.rand((D, N), generator=gen, dtype=dtype)
    params = GTNMFParams(
        lik=torch.tensor(1e-2, dtype=dtype),
        sub_var=torch.ones((D,), dtype=dtype),
        sub_len=torch.linspace(40.0, 120.0, D, dtype=dtype),
        omega=torch.linspace(0.1, 2.2, D, dtype=dtype),
        mod_var=torch.full((N,), 2.0, dtype=dtype),
        mod_len=torch.linspace(200.0, 400.0, N, dtype=dtype),
        W=torch.as_tensor(W, dtype=dtype),
    )
    return model, params.on(resolve_device(device))


def _metrics(model, params, Eft, y, sub, g):
    link = LINKS[model.link]
    D = model.D
    host = lambda x: torch.as_tensor(x).detach().cpu().double().numpy()
    z_hat, g_hat = host(Eft[:, :D]), host(Eft[:, D:])
    mods_hat = host(link(torch.as_tensor(g_hat)))
    amps = mods_hat @ host(params.W).T
    if model.variant == "sq":
        amps = np.sqrt(np.maximum(amps, 1e-12))
    y_hat = (z_hat * amps).sum(-1)
    mods_true = host(link(torch.as_tensor(host(g))))
    return {
        "rmse_sig": float(np.sqrt(np.mean((y_hat - host(y)) ** 2))),
        "rmse_sub": float(np.sqrt(np.mean((z_hat - host(sub)) ** 2))),
        "rmse_mod": float(np.sqrt(np.mean((mods_hat - mods_true) ** 2))),
    }


def run(T=4000, seed=0, ep_itts=4, engines=("ep", "ihgp", "giekf"), engine_kwargs=None,
        device=None, W=None, sample=None):
    """Returns {engine: {rmse_sig, rmse_sub, rmse_mod, seconds}}.  ``sample``:
    (y, subbands, modulator latents) to infer on instead of a fresh draw."""
    dev = resolve_device(device)
    model, params = toy_model(seed=seed, dtype=working_dtype(dev), device=dev, W=W)
    if sample is None:
        sample = sample_prior(torch.Generator().manual_seed(seed + 1), model, params, T=T)
    y, sub, g = (torch.as_tensor(x).to(dev, params.W.dtype) for x in sample)
    per_engine_kwargs = {
        "ep": dict(ep_itts=ep_itts),
        # IHGP needs the reference's heavy-damping regime (source_sep_piano.m
        # uses 0.025 x 10 iters); 0.5 damping diverges on low-noise toys.
        "ihgp": dict(ep_itts=4 * ep_itts, grid_lo=-4.0, damping=(0.1,)),
        "giekf": dict(g_iter=3, l_iter=5),
    }
    if engine_kwargs:
        for k, v in engine_kwargs.items():
            per_engine_kwargs[k].update(v)

    out = {"config": {"T": T, "seed": seed, "D": model.D, "N": model.N, "ep_itts": ep_itts}}
    for eng in engines:
        sync(dev)
        t0 = time.perf_counter()
        res = registry.infer(eng, model, params, y, None, device=dev, **per_engine_kwargs[eng])
        sync(dev)
        m = _metrics(model, params, res.Eft, y, sub, g)
        m["seconds"] = round(time.perf_counter() - t0, 3)
        m["nlZ_final"] = float(res.nlZ[-1]) if hasattr(res, "nlZ") else None
        out[eng] = m
    out["config"]["y_std"] = float(y.std(correction=0))
    return out


def main():
    import argparse

    ap = argparse.ArgumentParser()
    add_device_arg(ap)
    ap.add_argument("--T", type=int, default=4000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ep-itts", type=int, default=4)
    ap.add_argument("--out", default=os.path.join(OUT_ROOT, "synthetic_comparison.json"))
    args = ap.parse_args()
    res = run(T=args.T, seed=args.seed, ep_itts=args.ep_itts, device=args.device)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=2)
    print(json.dumps(res, indent=2))


if __name__ == "__main__":
    main()
