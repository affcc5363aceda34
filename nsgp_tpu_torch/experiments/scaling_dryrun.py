"""Scaling evidence on a mesh of ranks.

Port of ``nsgp_tpu/experiments/scaling_dryrun.py``: measures the
time-shard and channel-shard EP paths (``parallel.mesh``) at realistic shapes
(default T=196 608, D=16, N=3) in a world of ranks that it spawns itself (one
process a rank, ``parallel.mesh.spawn_world``), and writes
``results/torch/scaling_dryrun.json`` key for key with the JAX file.

What is and is NOT measurable here (stated in the output):
- Ranks that share one card (or the host's cores) compete for the same SMs
  and host cores, so wall-clock times are context, not scaling efficiency.
- What IS checkable and recorded:
  * partitioning correctness: each sharded result against the one-rank run;
  * the collectives each rank issued, by kind, with their bytes, as
    ``parallel.collectives`` counts them (the JAX driver reads its inventory
    from the compiled HLO instead); ``chunk_totals`` is the pass-2 exchange
    of the time-sharded blocked scan, beside the analytic model of it that
    the JAX driver writes down.

The arms run ``backend="seq"`` with the blocked scans, so sweep 1 is the
sequential ADF loop over T on every rank: at the default T an arm takes
minutes on the card.

CLI: python -m nsgp_tpu_torch.experiments.scaling_dryrun [--T 196608]
        [--chunk 2048] [--reps 2] [--world 8] [--device cuda|cpu]
        [--backend gloo|nccl]
(``gloo`` when the ranks share a card or run on the CPU, ``nccl`` for one
GPU a rank.)
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from nsgp_tpu_torch.experiments import OUT_ROOT, add_device_arg, sync, working_dtype
from nsgp_tpu_torch.utils.device import resolve_device

EP_ITTS = 2
CAVEAT = ("ranks share one host's cores, and on the card one GPU's SMs: wall "
          "times are sanity checks, not chip-scaling efficiency; the checkable "
          "evidence is result parity, the collectives each rank issued and "
          "their bytes, and the comms volume model")


def _inputs(T, D, N, dev):
    """The JAX driver's parameters and synthetic signal (numpy, seed 0)."""
    from nsgp_tpu_torch.convert import params_from_numpy
    from nsgp_tpu_torch.models.gtnmf import GTNMFModel

    model = GTNMFModel(D=D, N=N, kernel1="matern32", kernel2="matern52", p_cubature=9)
    rng = np.random.default_rng(0)
    params = params_from_numpy(dict(
        lik=np.float64(1e-3), sub_var=np.ones((D,)), sub_len=np.linspace(50.0, 300.0, D),
        omega=np.linspace(0.05, 2.8, D), mod_var=np.full((N,), 2.0),
        mod_len=np.linspace(800.0, 2500.0, N), W=rng.uniform(0.1, 1.0, (D, N)),
    ), device=dev, dtype=working_dtype(dev))
    # cheap synthetic signal (inference cost is data-independent)
    t = np.arange(T)
    y = np.sum([np.sin(w * t + p) * (1.0 + 0.5 * np.sin(2e-4 * t + p))
                for p, w in zip(rng.uniform(0, 6, 8), rng.uniform(0.05, 2.8, 8))], axis=0)
    return model, params, torch.tensor(y / y.std(), dtype=working_dtype(dev), device=dev)


def _rank(rank, T, D, N, chunk, mesh_sizes, reps, device):
    """One rank's share of every arm; rank 0 returns the results table."""
    from nsgp_tpu_torch.inference import ep
    from nsgp_tpu_torch.parallel import collectives
    from nsgp_tpu_torch.parallel import mesh as pmesh

    dev = resolve_device(device)
    world = dist.get_world_size()
    model, params, y = _inputs(T, D, N, dev)
    base_cfg = ep.EPConfig(ep_itts=EP_ITTS, parallel=True, chunk=chunk, moment_chunk=8192)
    out = {
        "experiment": "scaling_dryrun",
        "caveat": CAVEAT,
        "shape": {"T": T, "D": D, "N": N, "chunk": chunk, "ep_itts": EP_ITTS,
                  "n_devices": world, "device": (torch.cuda.get_device_name(dev)
                                                 if dev.type == "cuda" else "cpu"),
                  "backend": dist.get_backend(), "dtype": str(y.dtype)},
        "arms": [],
    }
    # analytic pass-2 exchange volume for the time-sharded blocked scan
    bs = 4  # matern32 x cos subband block
    C = D + N
    nc = -(-T // chunk)
    elem_bytes = C * (bs * bs + bs) * y.element_size()
    out["pass2_exchange_model"] = {
        "chunk_totals": nc,
        "bytes_per_chunk_total": elem_bytes,
        "total_bytes_per_pass": nc * elem_bytes,
        "note": ("the blocked scan's only cross-chunk communication (JAX's "
                 "model: one (bs x bs + bs) element a channel); measured "
                 "below as the 'chunk_totals' gathers: the filter's total is "
                 "3 bs^2 + 2 bs values a channel, the smoother's 2 bs^2 + bs, "
                 "and a gather hands every rank the whole (nc, ...) buffer"),
    }

    ref_mu = None
    for arm, axis, sizes in (("time_shard", "time", mesh_sizes),
                             ("channel_shard", "channel", (1, 2, 4))):
        for n in sizes:
            if n > world:
                continue
            mesh = pmesh.make_mesh({axis: n}, dev)
            if mesh is not None:
                cfg = base_cfg._replace(**{f"{axis}_axis": axis}) if n > 1 else base_cfg
                with pmesh.set_mesh(mesh):
                    fn = lambda: ep.ep_infer(model, params, y, None, cfg, device=dev)
                    collectives.reset_collectives()
                    sync(dev)
                    t0 = time.perf_counter()
                    r = fn()
                    mu = r.Eft.double().cpu().numpy()
                    cold = time.perf_counter() - t0
                    times = []
                    for _ in range(reps):
                        collectives.reset_collectives()
                        sync(dev)
                        t0 = time.perf_counter()
                        r = fn()
                        r.nlZ.cpu()
                        times.append(time.perf_counter() - t0)
                    coll = collectives.collective_stats()
                if rank == 0:
                    if ref_mu is None:
                        ref_mu, parity = mu, 0.0
                    else:
                        parity = float(np.nanmax(np.abs(mu - ref_mu)))
                    out["arms"].append({
                        "arm": arm, "devices": n,
                        "warm_seconds": float(np.median(times)) if times else None,
                        "cold_seconds": cold,
                        "max_abs_diff_vs_1dev": parity,
                        "collectives": coll,
                        "finite": bool(np.all(np.isfinite(mu))),
                    })
                    print(out["arms"][-1], file=sys.stderr, flush=True)
            dist.barrier()
    return out if rank == 0 else None


def run(T=196_608, D=16, N=3, chunk=2048, mesh_sizes=(1, 2, 4, 8), reps=2,
        save_path=os.path.join(OUT_ROOT, "scaling_dryrun.json"), world=None, device=None,
        backend="gloo"):
    """Spawn ``world`` ranks (default the largest mesh size) joined over
    ``backend`` on ``device`` (None = the card), run every arm that fits,
    write ``save_path`` and return the table.  Each arm runs once cold and
    ``reps`` times warm; its collectives are those of the last run."""
    from nsgp_tpu_torch.parallel import mesh as pmesh

    device = str(resolve_device(device))
    world = world or max(mesh_sizes)
    if device.startswith("cuda"):  # build the kernels once, before the ranks
        from nsgp_tpu_torch.ops import _build

        _build.library()
    out = pmesh.spawn_world(_rank, world, backend,
                            (T, D, N, chunk, tuple(mesh_sizes), reps, device))[0]
    os.makedirs(os.path.dirname(save_path), exist_ok=True)
    with open(save_path, "w") as f:
        json.dump(out, f, indent=2)
    return out


def main():
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--T", type=int, default=196_608)  # 96 chunks of 2048: divisible by every mesh size
    ap.add_argument("--chunk", type=int, default=2048)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--world", type=int, default=None,
                    help="ranks to spawn (default 8, the largest mesh); arms above it are skipped")
    add_device_arg(ap)
    ap.add_argument("--backend", default="gloo", choices=["gloo", "nccl"],
                    help="gloo when the ranks share a card or run on the CPU, nccl for one GPU a rank")
    args = ap.parse_args()
    run(T=args.T, chunk=args.chunk, reps=args.reps, world=args.world, device=args.device,
        backend=args.backend)


if __name__ == "__main__":
    main()
