"""Simulation-based calibration (SBC) of the HMC hyperparameter posterior.

Port of ``nsgp_tpu/experiments/hmc_sbc.py`` (Talts et al. 2018): draw
theta_i from the prior (uniform on the constraint box — the prior
``make_log_post`` implies), simulate y_i | theta_i, sample the posterior,
and record the rank of theta_i among the thinned draws.  A calibrated
posterior gives uniform ranks and ~90% coverage of the 90% CI regardless
of identifiability; a biased energy shows one-sided rank piles.  The
energy is switchable between the ADF (1-sweep) marginal likelihood and the
multi-sweep EP energy (ep_itts > 1).

Each replicate seeds three generators from its seed (the truth, the signal,
the sampler).  With ``subprocess_runs`` (the CLI's default, as the JAX
package's) each replicate runs in its own interpreter
(``python -m nsgp_tpu_torch.experiments.hmc_sbc --worker ...``), which
bounds a long grid's memory.

CLI: python -m nsgp_tpu_torch.experiments.hmc_sbc [--runs 16] [--itts 1 3]
        [--device cuda|cpu]
Writes results/torch/hmc_sbc.json.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

from nsgp_tpu_torch.experiments import OUT_ROOT, add_device_arg, working_dtype
from nsgp_tpu_torch.experiments.hmc_hypers import constrained_draws
from nsgp_tpu_torch.inference import hmc, learn
from nsgp_tpu_torch.models.gtnmf import GTNMFModel, GTNMFParams, sample_prior
from nsgp_tpu_torch.utils.device import resolve_device

# Free groups and their prior boxes (same style as hmc_hypers.SPECS)
SPECS = {
    "lik": (1e-4, 0.1),
    "sub_var": "fixed",
    "sub_len": "fixed",
    "omega": "fixed",
    "mod_var": (0.5, 8.0),
    "mod_len": (50.0, 600.0),
    "W": "fixed",
}
FREE = ("lik", "mod_var", "mod_len")


def _base(D=4, N=2, seed=0, device="cpu", dtype=torch.float64):
    model = GTNMFModel(D=D, N=N, kernel1="matern32", kernel2="matern52", p_cubature=7)
    W = 0.2 + 0.8 * torch.rand((D, N), generator=torch.Generator().manual_seed(seed),
                               dtype=dtype)
    ref = GTNMFParams(
        lik=torch.tensor(1e-2, dtype=dtype),
        sub_var=torch.ones((D,), dtype=dtype),
        sub_len=torch.linspace(40.0, 120.0, D, dtype=dtype),
        omega=torch.linspace(0.3, 2.2, D, dtype=dtype),
        mod_var=torch.full((N,), 2.0, dtype=dtype),
        mod_len=torch.linspace(150.0, 300.0, N, dtype=dtype),
        W=W,
    )
    return model, ref.on(resolve_device(device))


def _draw_prior(generator: torch.Generator, ref: GTNMFParams) -> GTNMFParams:
    """theta ~ prior: uniform on each free group's constraint box."""
    kw = dict(zip(("lik", "sub_var", "sub_len", "omega", "mod_var", "mod_len", "W"),
                  ref.leaves()))
    for g in FREE:
        lo, hi = SPECS[g]
        x = kw[g]
        u = torch.rand(x.shape, generator=generator, dtype=x.dtype).to(x.device)
        kw[g] = lo + (hi - lo) * u
    return GTNMFParams(**kw)


def _flatten_free(params: GTNMFParams):
    names, vals = [], []
    for g in FREE:
        v = np.atleast_1d(getattr(params, g).double().cpu().numpy())
        for j in range(v.shape[0]):
            names.append(f"{g}[{j}]" if v.shape[0] > 1 else g)
            vals.append(float(v[j]))
    return names, np.asarray(vals)


def run_one(seed, model, ref, T, ep_itts, n_chains, n_samples, thin, n_leapfrog=8,
            device=None):
    """One SBC replicate: returns (names, ranks, in90, n_draws_thinned,
    acceptance per chain)."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    kp, ky, kh = (torch.Generator().manual_seed(int(s))
                  for s in torch.randint(0, 2**62, (3,), generator=gen))
    truth = _draw_prior(kp, ref)
    y, _, _ = sample_prior(ky, model, truth, T=T)

    tf = learn.Transform(specs=SPECS)
    energy = learn.make_energy_fn(model, y, engine="ep", device=dev, ep_itts=ep_itts)
    log_post = hmc.make_log_post(energy, tf, ref)
    u0 = tf.to_unconstrained(truth)  # start near truth: SBC checks shape,
    # not burn-in robustness; warmup still moves chains off it

    res = hmc.hmc_sample(
        kh, log_post, u0,
        hmc.HMCConfig(n_samples=n_samples, n_warmup=n_samples, n_leapfrog=n_leapfrog,
                      init_step_size=0.05),
        n_chains=n_chains, jitter_init=0.2)

    names, tvals = _flatten_free(truth)
    draws = {g: constrained_draws(res, tf, ref, g) for g in FREE}
    ranks, in90 = [], []
    for i, name in enumerate(names):
        g, j = (name.split("[")[0], int(name.split("[")[1][:-1])) if "[" in name else (name, 0)
        d = draws[g]
        flat = d[:, ::thin, j].reshape(-1)
        ranks.append(int(np.sum(flat < tvals[i])))
        lo, hi = np.quantile(d[:, :, j].reshape(-1), [0.05, 0.95])
        in90.append(bool(lo <= tvals[i] <= hi))
    acc = res.accept_rate.double().cpu().numpy()
    return names, ranks, in90, len(flat), acc


def _run_one_subprocess(seed, T, itts, n_chains, n_samples, thin, leap, device):
    """One replicate in a fresh interpreter (see the module docstring)."""
    import subprocess

    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    path = os.pathsep.join(p for p in (root, os.environ.get("PYTHONPATH")) if p)
    out = subprocess.run(
        [sys.executable, "-m", "nsgp_tpu_torch.experiments.hmc_sbc", "--worker",
         str(seed), str(T), str(itts), str(n_chains), str(n_samples), str(thin), str(leap),
         str(device)],
        capture_output=True, text=True, timeout=3600, env={**os.environ, "PYTHONPATH": path},
    )
    if out.returncode != 0 or not out.stdout.strip():
        raise RuntimeError(f"SBC worker (seed={seed}) failed rc={out.returncode}; "
                           f"stderr tail: {out.stderr[-2000:]}")
    d = json.loads(out.stdout.strip().splitlines()[-1])
    return d["names"], d["ranks"], d["in90"], d["L"], np.asarray(d["accept"])


def run(runs=16, T=1000, ep_itts_arms=(1, 3), n_chains=2, n_samples=100, thin=5, seed0=0,
        arm_overrides=None, save_path=None, subprocess_runs=True, device=None):
    """arm_overrides: {ep_itts: dict} per-arm budget (runs/n_samples/
    n_leapfrog) — the multi-sweep energy's gradient costs several ADF ones,
    so its arm runs a smaller but still rank-resolving budget."""
    dev = resolve_device(device)
    model, ref = _base(device=dev, dtype=working_dtype(dev))
    out = {"experiment": "hmc_sbc", "T": T, "runs": runs, "n_chains": n_chains,
           "n_samples": n_samples, "thin": thin, "arms": []}
    for itts in ep_itts_arms:
        ov = (arm_overrides or {}).get(itts, {})
        a_runs = ov.get("runs", runs)
        a_samples = ov.get("n_samples", n_samples)
        a_leap = ov.get("n_leapfrog", 8)
        t0 = time.perf_counter()
        all_ranks, all_in90, names, L = {}, {}, None, None
        accs = []
        for r in range(a_runs):
            seed = seed0 + 1000 * r + itts
            if subprocess_runs:
                names, ranks, in90, L, acc = _run_one_subprocess(
                    seed, T, itts, n_chains, a_samples, thin, a_leap, dev)
            else:
                names, ranks, in90, L, acc = run_one(
                    seed, model, ref, T, itts, n_chains, a_samples, thin, n_leapfrog=a_leap,
                    device=dev)
            accs.append(float(acc.mean()))
            for n, rk, c in zip(names, ranks, in90):
                all_ranks.setdefault(n, []).append(rk)
                all_in90.setdefault(n, []).append(c)
            print(f"[sbc itts={itts}] run {r + 1}/{a_runs} ranks={dict(zip(names, ranks))}",
                  file=sys.stderr, flush=True)
        # Uniformity: chi-square over quartile bins of rank/L, plus the
        # one-sided pile fractions.
        rows = []
        for n in names:
            rk = np.asarray(all_ranks[n], float) / L
            counts, _ = np.histogram(rk, bins=4, range=(0.0, 1.0))
            expect = a_runs / 4.0
            chi2 = float(np.sum((counts - expect) ** 2 / expect))
            rows.append({
                "param": n,
                "rank_mean": round(float(rk.mean()), 3),  # 0.5 if calibrated
                "frac_rank_lt_10pct": round(float(np.mean(rk < 0.1)), 3),
                "frac_rank_gt_90pct": round(float(np.mean(rk > 0.9)), 3),
                "chi2_4bin": round(chi2, 2),  # 95% crit for df=3: 7.81
                "coverage_90ci": round(float(np.mean(all_in90[n])), 3),
            })
        out["arms"].append({
            "ep_itts": itts,
            "runs": a_runs,
            "n_samples": a_samples,
            "n_leapfrog": a_leap,
            "mean_accept": round(float(np.mean(accs)), 3),
            "per_param": rows,
            "mean_coverage_90ci": round(float(np.mean([r["coverage_90ci"] for r in rows])), 3),
            "seconds": round(time.perf_counter() - t0, 1),
        })
        if save_path:  # incremental save: a later arm's failure keeps this one
            with open(save_path, "w") as f:
                json.dump(out, f, indent=2)
    return out


def main():
    import argparse

    if len(sys.argv) > 1 and sys.argv[1] == "--worker":
        # one replicate, JSON line on stdout (see _run_one_subprocess)
        seed, T, itts, n_chains, n_samples, thin, leap = (int(v) for v in sys.argv[2:9])
        dev = resolve_device(sys.argv[9])
        model, ref = _base(device=dev, dtype=working_dtype(dev))
        names, ranks, in90, L, acc = run_one(seed, model, ref, T, itts, n_chains, n_samples,
                                             thin, n_leapfrog=leap, device=dev)
        print(json.dumps({"names": names, "ranks": ranks, "in90": in90, "L": L,
                          "accept": [float(a) for a in acc]}))
        return

    ap = argparse.ArgumentParser()
    add_device_arg(ap)
    ap.add_argument("--runs", type=int, default=16)
    ap.add_argument("--T", type=int, default=1000)
    ap.add_argument("--itts", nargs="+", type=int, default=[1, 3])
    ap.add_argument("--out", default=os.path.join(OUT_ROOT, "hmc_sbc.json"))
    args = ap.parse_args()
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    res = run(runs=args.runs, T=args.T, ep_itts_arms=tuple(args.itts),
              arm_overrides={3: dict(runs=max(8, args.runs * 3 // 4), n_samples=64,
                                     n_leapfrog=4)},
              save_path=args.out, device=args.device)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=2)
    print(json.dumps(res, indent=2))


if __name__ == "__main__":
    main()
