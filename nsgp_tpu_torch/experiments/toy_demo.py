"""Toy GT-NMF demo (ref demo_toy_modulators_nmf.m / demo_toy_modulators.m).

Port of ``nsgp_tpu/experiments/toy_demo.py``.  Samples subbands +
modulators from the prior at fixed seeds, runs EP inference at the true
hyperparameters, and prints signal/subband/modulator RMSEs and the per-sweep
energies — the reference's de-facto correctness demo (:13-14, :177-178).
Pass --per-subband for the non-NMF model (one modulator per subband,
ss_modulators.m: N = D, W = I).  W and the sample come from generators
seeded from ``seed`` or are given (``W=``, ``sample=``).

CLI: python -m nsgp_tpu_torch.experiments.toy_demo [--T 2000] [--per-subband]
        [--device cuda|cpu]
Writes results/torch/toy_demo.json.
"""

from __future__ import annotations

import json
import os

import torch

from nsgp_tpu_torch.experiments import OUT_ROOT, add_device_arg, working_dtype
from nsgp_tpu_torch.experiments.synthetic import _metrics, toy_model
from nsgp_tpu_torch.inference import ep
from nsgp_tpu_torch.models.gtnmf import per_subband_params, sample_prior
from nsgp_tpu_torch.utils.device import resolve_device


def run(T=2000, seed=123, ep_itts=5, per_subband=False, device=None, W=None, sample=None):
    dev = resolve_device(device)
    dtype = working_dtype(dev)
    model, params = toy_model(D=6, N=2, seed=seed, dtype=dtype, device=dev, W=W)
    if per_subband:
        # non-NMF model: one modulator per subband (gf_ep_modulator.m path)
        params = per_subband_params(
            params.lik, params.sub_var, params.sub_len, params.omega,
            torch.full((model.D,), 2.0, dtype=dtype, device=dev),
            torch.linspace(200.0, 400.0, model.D, dtype=dtype, device=dev),
        )
        model = model._replace(N=model.D)
    if sample is None:
        sample = sample_prior(torch.Generator().manual_seed(seed + 1), model, params, T=T)
    y, sub, g = (torch.as_tensor(x).to(dev, dtype) for x in sample)
    res = ep.ep_infer(model, params, y, None, ep.EPConfig(ep_itts=ep_itts), device=dev)
    m = _metrics(model, params, res.Eft, y, sub, g)
    m.update({
        "model": "per_subband" if per_subband else "nmf",
        "T": T, "seed": seed, "ep_itts": ep_itts,
        "y_std": float(y.std(correction=0)),
        "nlZ": res.nlZ.cpu().tolist(),
        "maxdiff": res.maxdiff.cpu().tolist(),
    })
    return m


def main():
    import argparse

    ap = argparse.ArgumentParser()
    add_device_arg(ap)
    ap.add_argument("--T", type=int, default=2000)
    ap.add_argument("--seed", type=int, default=123)
    ap.add_argument("--per-subband", action="store_true")
    ap.add_argument("--out", default=os.path.join(OUT_ROOT, "toy_demo.json"))
    args = ap.parse_args()
    res = run(T=args.T, seed=args.seed, per_subband=args.per_subband, device=args.device)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=2)
    print(json.dumps(res, indent=2))


if __name__ == "__main__":
    main()
