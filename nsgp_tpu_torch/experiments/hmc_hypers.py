"""HMC + VI posterior over GT-NMF hyperparameters (north-star layer).

Port of ``nsgp_tpu/experiments/hmc_hypers.py``.  Sample a toy GT-NMF signal
at known hyperparameters, run multi-chain HMC over {lik, mod_var, mod_len}
with the single-sweep ADF energy as the likelihood, and check that (a)
chains mix (split-R-hat ~ 1, healthy acceptance), (b) the posterior
concentrates on hyperparameters whose marginal-likelihood energy is at least
as good as the generative truth's, and (c) mean-field VI lands inside the
HMC posterior's central mass at a fraction of the cost.  Truth-vs-posterior
rows are diagnostics: the GT-NMF likelihood is weakly identified in the
modulator lengthscales (see the JAX module).

The toy's W comes from a generator seeded with ``seed``, its signal from
one seeded with ``seed + 1`` (or ``W=``, ``y=``); HMC and VI draw from
generators seeded with ``seed + 1`` and ``seed + 2``.  The chains run one
after another (``inference.hmc``).

CLI: python -m nsgp_tpu_torch.experiments.hmc_hypers [--device cuda|cpu]
Writes results/torch/hmc_hypers.json.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from nsgp_tpu_torch.experiments import OUT_ROOT, add_device_arg, sync, working_dtype
from nsgp_tpu_torch.inference import hmc, learn
from nsgp_tpu_torch.models.gtnmf import GTNMFModel, GTNMFParams, sample_prior
from nsgp_tpu_torch.utils.device import resolve_device

# Box constraints in the style of the reference's ranges
# (train_GTFNMF_gaps.m:117-122): the scaled-sigmoid bijector bounds the
# support of the weakly identified groups.
SPECS = {
    "lik": (1e-4, 0.1),
    "sub_var": "fixed",
    "sub_len": "fixed",
    "omega": "fixed",
    "mod_var": (0.5, 8.0),
    "mod_len": (50.0, 800.0),
    "W": "fixed",
}


def _toy(D=4, N=2, T=2000, seed=0, device="cpu", dtype=torch.float64, W=None, y=None):
    model = GTNMFModel(D=D, N=N, kernel1="matern32", kernel2="matern52", p_cubature=7)
    if W is None:
        W = 0.2 + 0.8 * torch.rand((D, N), generator=torch.Generator().manual_seed(seed),
                                   dtype=dtype)
    params = GTNMFParams(
        lik=torch.tensor(1e-2, dtype=dtype),
        sub_var=torch.ones((D,), dtype=dtype),
        sub_len=torch.linspace(40.0, 120.0, D, dtype=dtype),
        omega=torch.linspace(0.3, 2.2, D, dtype=dtype),
        mod_var=torch.full((N,), 2.0, dtype=dtype),
        mod_len=torch.linspace(150.0, 300.0, N, dtype=dtype),
        W=torch.as_tensor(W, dtype=dtype),
    ).on(resolve_device(device))
    if y is None:
        y, _, _ = sample_prior(torch.Generator().manual_seed(seed + 1), model, params, T=T)
    return model, params, torch.as_tensor(y).to(params.W.device, dtype)


def _split_rhat(x: np.ndarray) -> float:
    """Split-chain R-hat over (chains, draws) for one scalar parameter."""
    c, n = x.shape
    half = n // 2
    chains = np.concatenate([x[:, :half], x[:, half: 2 * half]], axis=0)
    m, n = chains.shape
    means = chains.mean(axis=1)
    W = chains.var(axis=1, ddof=1).mean()
    B = n * means.var(ddof=1)
    var_plus = (n - 1) / n * W + B / n
    return float(np.sqrt(var_plus / (W + 1e-300)))


def constrained_draws(res, tf, ref, group: str) -> np.ndarray:
    """One group's HMC draws in the constrained space, (chains, draws, size)."""
    return np.stack([
        np.stack([np.atleast_1d(getattr(tf.to_params(res.unravel(q), ref), group)
                                .double().cpu().numpy()) for q in chain])
        for chain in res.samples])


def run(T=2000, n_chains=4, n_samples=150, n_warmup=150, seed=0, device=None, W=None, y=None):
    dev = resolve_device(device)
    model, true_params, y = _toy(T=T, seed=seed, device=dev, dtype=working_dtype(dev), W=W,
                                 y=y)
    tf = learn.Transform(specs=SPECS)
    energy = learn.make_energy_fn(model, y, engine="ep", device=dev, ep_itts=1)
    log_post = hmc.make_log_post(energy, tf, true_params)

    # start chains from a perturbed init (not the truth)
    init = GTNMFParams(
        lik=true_params.lik * 3.0, sub_var=true_params.sub_var,
        sub_len=true_params.sub_len, omega=true_params.omega,
        mod_var=true_params.mod_var * 0.5, mod_len=true_params.mod_len * 1.5,
        W=true_params.W)
    u0 = tf.to_unconstrained(init)

    sync(dev)
    t0 = time.perf_counter()
    res = hmc.hmc_sample(
        torch.Generator().manual_seed(seed + 1), log_post, u0,
        hmc.HMCConfig(n_samples=n_samples, n_warmup=n_warmup, n_leapfrog=8,
                      init_step_size=0.05),
        n_chains=n_chains, jitter_init=0.2)
    sync(dev)
    hmc_s = time.perf_counter() - t0

    names, truths, posts = [], [], []
    for g in ("lik", "mod_var", "mod_len"):
        tr = np.atleast_1d(getattr(true_params, g).double().cpu().numpy())
        dr = constrained_draws(res, tf, true_params, g)
        for j in range(tr.shape[0]):
            names.append(f"{g}[{j}]" if tr.shape[0] > 1 else g)
            truths.append(float(tr[j]))
            posts.append(dr[:, :, j])

    t0 = time.perf_counter()
    vi = hmc.vi_fit(torch.Generator().manual_seed(seed + 2), log_post, u0, steps=200, n_mc=2)
    sync(dev)
    vi_s = time.perf_counter() - t0
    vi_params = tf.to_params(vi.unravel(vi.mean), true_params)

    # correctness check: the posterior should concentrate on hypers whose
    # energy is at least as good as the generative truth's
    q_mean = res.samples.reshape(-1, res.samples.shape[-1]).mean(0)
    post_mean_params = tf.to_params(res.unravel(q_mean), true_params)
    with torch.no_grad():
        energy_true = float(energy(true_params))
        energy_post = float(energy(post_mean_params))
        energy_vi = float(energy(vi_params))

    rows = []
    for name, tr, post in zip(names, truths, posts):
        flat = post.reshape(-1)
        lo, hi = np.quantile(flat, [0.05, 0.95])
        rows.append({
            "param": name,
            "true": tr,
            "post_mean": float(flat.mean()),
            "q05": float(lo),
            "q95": float(hi),
            "in_90ci": bool(lo <= tr <= hi),
            "rhat": round(_split_rhat(post), 4),
        })
    g_map = {"lik": float(vi_params.lik),
             "mod_var": vi_params.mod_var.double().cpu().tolist(),
             "mod_len": vi_params.mod_len.double().cpu().tolist()}
    return {
        "experiment": "hmc_hypers",
        "T": T,
        "n_chains": n_chains,
        "n_samples": n_samples,
        "accept_rate": [round(v, 3) for v in res.accept_rate.double().cpu().tolist()],
        "step_size": [round(v, 5) for v in res.step_size.double().cpu().tolist()],
        "posterior": rows,
        "coverage_90ci": float(np.mean([r["in_90ci"] for r in rows])),
        "max_rhat": max(r["rhat"] for r in rows),
        "energy_true": round(energy_true, 3),
        "energy_post_mean": round(energy_post, 3),
        "energy_vi_mean": round(energy_vi, 3),
        "post_beats_truth": bool(energy_post <= energy_true),
        "vi": {"params": g_map,
               "elbo_final": float(vi.elbo_trace[-10:].mean())},
        "hmc_seconds": round(hmc_s, 2),
        "vi_seconds": round(vi_s, 2),
    }


def main():
    import argparse

    ap = argparse.ArgumentParser()
    add_device_arg(ap)
    ap.add_argument("--T", type=int, default=2000)
    ap.add_argument("--samples", type=int, default=150)
    ap.add_argument("--out", default=os.path.join(OUT_ROOT, "hmc_hypers.json"))
    args = ap.parse_args()
    res = run(T=args.T, n_samples=args.samples, n_warmup=args.samples, device=args.device)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=2)
    print(json.dumps(res, indent=2))


if __name__ == "__main__":
    main()
