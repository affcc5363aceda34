"""What one training evaluation costs on the card, step by step.

    python -m nsgp_tpu_torch.tools.probe_train [T ...]

For the speech model that ``chip_smoke.py`` phase 7 trains
(``trained_speech0_female_exp.npz``: D=16, N=3, exp/matern52, 'sq', 77 sigma
points), at each T (default 1024 and 16 000, the training length; the CPU
only up to 1024) and in float32 and float64, on the card and on the CPU: the
ADF energy (``ep_itts=1``) forward alone, without a graph, and value and
gradient with respect to every parameter leaf, in s and in us per step; on
the card also the kernel launches of a value and gradient (sweep 1 is K3
forward and K7 backward), K7 alone (``fused_adf_vjp`` on K3's outputs with
lZ's cotangent, CUDA events), the peak memory, and the CUDA kernels and the
device-busy time of the forward call and of the backward call
(``torch.profiler``, per call and per step), and the host copies and stream
synchronisations of a value and gradient at T = 16 and 64 by the op that
issued them.  Then the GIEKF energy's value and gradient and a
``giekf_infer`` (dense m = 57) the same way at the shortest T.
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from nsgp_tpu_torch.convert import load_trained  # noqa: E402
from nsgp_tpu_torch.inference import ep, giekf  # noqa: E402
from nsgp_tpu_torch.models.gtnmf import PARAM_NAMES, GTNMFParams, sample_prior  # noqa: E402
from nsgp_tpu_torch.ops import fused_kalman as fk  # noqa: E402

MODEL = (Path(__file__).resolve().parents[2]
         / "results" / "trained" / "speech" / "trained_speech0_female_exp.npz")
T_CPU = 1024  # the plain twins are Python loops over T: longer only on the card


def timed(fn, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def leaves_of(params):
    leaves = {k: getattr(params, k).detach().clone().requires_grad_(True) for k in PARAM_NAMES}
    return leaves, GTNMFParams(**leaves)


def value_and_grad(energy, params):
    leaves, p = leaves_of(params)
    e = energy(p)
    return e, torch.autograd.grad(e, list(leaves.values()))


def kernels_per_step(energy, params, T):
    """CUDA kernels per step and device-busy us per step, in the forward call
    and in the backward call: ((kernels fwd, kernels bwd), (busy fwd, busy
    bwd), (wall fwd, wall bwd)), the walls in us per step under tracing."""
    from torch.profiler import ProfilerActivity, profile

    leaves, p = leaves_of(params)
    kernels, busy, wall = [], [], []
    for phase in ("forward", "backward"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            if phase == "forward":
                e = energy(p)
            else:
                torch.autograd.grad(e, list(leaves.values()))
            torch.cuda.synchronize()
        wall.append(1e6 * (time.perf_counter() - t0) / T)
        cuda = [ev for ev in prof.key_averages()
                if ev.device_type == torch.autograd.DeviceType.CUDA]
        kernels.append(sum(ev.count for ev in cuda) / T)
        busy.append(sum(ev.self_device_time_total for ev in cuda) / T)
    return tuple(kernels), tuple(busy), tuple(wall)


def vjp_ms(model, params, y, reps=3):
    """Device ms of one K7 launch on K3's outputs for y, lZ's cotangent ones."""
    ssm = model.build_ssm(params)
    mp = model.moment_params()
    dt_ = ssm.A.dtype
    wn, xi = fk.sigma_points(mp, dt_, y.device)
    args = (y.to(dt_), torch.ones_like(y, dtype=dt_), ssm.A, ssm.Q, ssm.Pinf, ssm.H, params.W,
            xi, wn, params.lik)
    kw = dict(damp=0.5, link=mp.link, variant=mp.variant, z_floor=mp.z_floor)
    ms, Ps, lZ, _, _ = fk.fused_adf(*args, **kw)
    run = lambda: fk.fused_adf_vjp(*args, ms, Ps, None, None, torch.ones_like(lZ), None, None,
                                   **kw)
    run()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        run()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def copies_and_syncs(energy, params, T):
    """Host-side copies and stream synchronisations in one forward and
    backward call (``torch.profiler``), by the op that issued them:
    {(runtime call, op chain): count}."""
    from torch.profiler import ProfilerActivity, profile

    leaves, p = leaves_of(params)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        e = energy(p)
        torch.autograd.grad(e, list(leaves.values()))
        torch.cuda.synchronize()
    counts = {}
    for ev in prof.events():
        if ev.name in ("cudaMemcpyAsync", "cudaStreamSynchronize", "cudaMemcpy"):
            chain, parent = [], ev.cpu_parent
            while parent is not None and len(chain) < 3:
                chain.append(parent.name)
                parent = parent.cpu_parent
            key = (ev.name, " <- ".join(chain))
            counts[key] = counts.get(key, 0) + 1
    return counts


def main(Ts) -> int:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    for dtype in (torch.float32, torch.float64):
        for dev in (torch.device("cuda"), torch.device("cpu")):
            model, params = load_trained(MODEL, device=dev, dtype=dtype)
            y_all, _, _ = sample_prior(torch.Generator().manual_seed(0), model, params, max(Ts))
            cfg = ep.EPConfig(ep_itts=1)
            for T in Ts:
                if dev.type == "cpu" and T > T_CPU:
                    continue
                y = y_all[:T]
                energy = lambda p: ep.ep_energy(model, p, y, None, cfg, device=dev)
                with torch.no_grad():
                    timed(lambda: energy(params), dev)  # warm-up
                    _, fwd_s = timed(lambda: energy(params), dev)
                if dev.type == "cuda":
                    torch.cuda.reset_peak_memory_stats()
                    fk.reset_launches()
                (e, g), vg_s = timed(lambda: value_and_grad(energy, params), dev)
                line = (f"ep_energy {str(dtype)[6:]} {dev.type} T={T}: forward {fwd_s:.3f} s "
                        f"({1e6 * fwd_s / T:.0f} us/step), value+grad {vg_s:.3f} s "
                        f"({1e6 * vg_s / T:.0f} us/step), energy {e.item():.6g}")
                if dev.type == "cuda":
                    peak = torch.cuda.max_memory_allocated() / 2**20
                    launches = {fn.__name__: fn.launches for fn in fk.WRAPPERS if fn.launches}
                    (kf, kb), (bf, bb), (wf, wb) = kernels_per_step(energy, params, T)
                    line += (f", peak {peak:.0f} MiB, launches {launches}, K7 alone "
                             f"{vjp_ms(model, params, y):.2f} ms; traced: CUDA kernels forward "
                             f"{kf * T:.0f}, backward {kb * T:.0f} a call, device busy "
                             f"{bf:.2f} of {wf:.2f} us/step forward, {bb:.2f} of {wb:.2f} "
                             f"backward")
                print(line, flush=True)
            if dev.type == "cuda":
                for T_c in (16, 64):  # what grows with T is per step, the rest per call
                    counts = copies_and_syncs(
                        lambda p: ep.ep_energy(model, p, y_all[:T_c], None, cfg, device=dev),
                        params, T_c)
                    for (call, chain), n in sorted(counts.items(), key=lambda kv: -kv[1]):
                        print(f"  T={T_c}: {n} x {call} <- {chain}", flush=True)
            T = min(Ts + [T_CPU])
            y = y_all[:T]
            genergy = lambda p: giekf.giekf_energy(model, p, y, None, device=dev)
            (e, g), vg_s = timed(lambda: value_and_grad(genergy, params), dev)
            r, inf_s = timed(lambda: giekf.giekf_infer(model, params, y, None, device=dev), dev)
            print(f"giekf {str(dtype)[6:]} {dev.type} T={T}: energy value+grad {vg_s:.3f} s "
                  f"({1e6 * vg_s / T:.0f} us/step), giekf_infer {inf_s:.3f} s "
                  f"({1e6 * inf_s / T:.0f} us/step), nll {r.nll.item():.6g}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main([int(t) for t in sys.argv[1:]] or [1024, 16_000]))
