"""Cycles per step, by phase, of the ADF kernels' shared step on the card.

    python -m nsgp_tpu_torch.tools.probe_adf_cycles [T_headline [T_mixture]]
    (defaults 20 000 and 4 000 steps)
    python -m nsgp_tpu_torch.tools.probe_adf_cycles --kernel vjp [T]
    (default 16 000 steps)

Builds ``csrc/fused_adf_mb_f32.cu`` with ``-DNSGP_CLOCK_PROBE`` into a library of
its own under ``build/`` (the shipped library is built without the define and
carries no probe code), runs it through the K4 wrapper at the headline shape
(BF=1, D=16, N=3, 77 sigma points: the code K3 runs) and at mixture width
(D=48, N=9, 3973 sigma points, a cluster of CTAs), float32, on the inputs of
``chip_smoke.py``, and prints what thread 0 of CTA 0 counted with clock64():

    predict          start of a step -> the marginals are published
    evaluate         the lane's sigma points, in five parts: link values,
                     amplitudes, s2e / mean and their butterfly, weights, totals
    merge            warp butterfly, the warps' records, the CTA's record
    cluster barrier  cluster.sync() (zero without a cluster)
    site + update    final merge by the channel threads, site, update, stores

and the kernel's time by CUDA events.  The probed kernel is a little slower
than the shipped one; the phases' shares are what the numbers are for.

``--kernel vjp`` probes K7 (``csrc/fused_adf_vjp.cuh``, built from
``fused_adf_vjp_f32.cu``) instead, at the training cell's shapes: the trained
speech model (D=16, N=3, 77 sigma points, block size 3), float32, T steps of a
draw from its prior, lZ's cotangent -1 a step (what a value and gradient of
the energy gives).  It prints K7's time by CUDA events (probed, shipped, and
shipped without the per-point record, so that the walk re-evaluates the
points), each of its two kernels' device time (``torch.profiler``), and the
reverse walk's cycles a step by phase, as thread 0 (a channel thread, warp 0:
``VJP_CHANNEL``) and thread 32 (a lane of the points, warp 1: ``VJP_POINTS``)
see them.  The marks are clock64() reads that the compiler may move work
across, and two warps on a scheduler share it, so a phase's count is
approximate; the probed walk is about 13% slower than the shipped one.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import chip_smoke as cs  # noqa: E402
from nsgp_tpu_torch.models import mixture  # noqa: E402
from nsgp_tpu_torch.models.gtnmf import stack_params  # noqa: E402
from nsgp_tpu_torch.ops import _build  # noqa: E402
from nsgp_tpu_torch.ops import fused_kalman as fk  # noqa: E402

PHASES = ("predict", "  link values", "  amplitudes", "  s2e, mean", "  weights", "  totals",
          "merge", "cluster barrier", "site + update")
EVALUATE = slice(1, 6)
# K7's walk, as two threads see a reverse step: thread 0 (a channel thread,
# warp 0) and thread 32 (a lane of the points, warp 1)
VJP_CHANNEL = ("ring, publish", "update, site reverse", "wait at barrier A",
               "float64 sums, barrier B", "reads for the reverse", "prediction reverse",
               "parameter cotangents kept", "the lanes' sums")
VJP_POINTS = ("read the ring", "wait at barrier A", "gZ", "cotangents", "merge, barrier B",
              "W's cotangent")


def probe(label, lib, model, paramsB, yB, steps):
    dev = yB.device
    cycles = torch.zeros(len(PHASES) + 1, dtype=torch.int64, device=dev)
    kern, _ = cs.adf_mb_case(model, paramsB, yB, torch.ones_like(yB) > 0, 256, steps=steps,
                             _lib=lib, _cycles=cycles)
    ms = cs.cuda_ms(kern, 1)
    c = cycles.cpu().tolist()
    if lib.nsgp_adf_probe_phases() != len(PHASES):
        raise RuntimeError("the probe's phases and the kernel's disagree")
    n = max(c[-1], 1)
    c = c[:-1]
    total = sum(c)
    S = fk.sigma_points(model.moment_params(), torch.float32, dev)[0].shape[0]
    shape = fk.adf_launch_shape(S)
    print(f"{label}: D={model.D} N={model.N} S={S} T={steps} f32 threads={shape['threads']} "
          f"cluster={shape['cluster']}: {ms:.1f} ms probed = {1e3 * ms / steps:.2f} us/step; "
          f"{total / n:.0f} cycles/step over {n} observed steps")
    rows = list(zip(PHASES, c))
    rows.insert(EVALUATE.start, ("evaluate", sum(c[EVALUATE])))
    for name, v in rows:
        print(f"  {name:16s} {v / n:9.0f} cycles/step  {100.0 * v / max(total, 1):5.1f}%")


def probe_vjp(lib, steps):
    """K7 at the training cell's shapes: the walk's cycles by phase, then the
    two kernels' device times (torch.profiler) and K7's by CUDA events."""
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda")
    model, init, y = cs.speech_inputs(torch.float32, dev, steps)
    mask = torch.ones(steps, dtype=torch.bool, device=dev)
    _, _, outs = cs.vjp_case(model, init, y, mask, True)
    ssm = model.build_ssm(init)
    mp = model.moment_params()
    wn, xi = fk.sigma_points(mp, torch.float32, dev)
    kw = dict(damp=0.5, link=mp.link, variant=mp.variant, z_floor=mp.z_floor)
    args = (y, mask.float(), ssm.A, ssm.Q, ssm.Pinf, ssm.H, init.W, xi, wn, init.lik,
            outs[0], outs[1], None, None, -torch.ones(steps, device=dev), None, None)
    n_slots = lib.nsgp_adf_vjp_probe_slots()
    half = lib.nsgp_adf_probe_phases() + 1
    if n_slots != 2 * half or max(len(VJP_CHANNEL), len(VJP_POINTS)) >= half:
        raise RuntimeError("the probe's slots and K7's disagree")
    cycles = torch.zeros(n_slots, dtype=torch.int64, device=dev)
    fk.reset_launches()
    probed = cs.cuda_ms(lambda: fk.fused_adf_vjp(*args, **kw, _lib=lib, _cycles=cycles), 1)
    shipped = cs.cuda_ms(lambda: fk.fused_adf_vjp(*args, **kw), 3)
    stashed = fk.fused_adf_vjp.stashed == fk.fused_adf_vjp.launches
    budget, fk.VJP_STASH_BYTES = fk.VJP_STASH_BYTES, 0
    try:  # the walk that re-evaluates the points
        again = cs.cuda_ms(lambda: fk.fused_adf_vjp(*args, **kw), 3)
    finally:
        fk.VJP_STASH_BYTES = budget
    cycles.zero_()
    fk.fused_adf_vjp(*args, **kw, _lib=lib, _cycles=cycles)
    c = cycles.cpu().tolist()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fk.fused_adf_vjp(*args, **kw)
        torch.cuda.synchronize()
    parts = {}
    for ev in prof.key_averages():
        if "fused_adf_vjp_kernel" in ev.key:
            parts[ev.key] = getattr(ev, "device_time_total", 0.0) / 1e3 / max(ev.count, 1)
    print(f"K7: D={model.D} N={model.N} S={wn.shape[0]} bs={ssm.block_size} T={steps} f32, "
          f"per-point record {'read' if stashed else 'not read'}: {probed:.2f} ms probed, "
          f"{shipped:.2f} ms shipped = {1e3 * shipped / steps:.2f} us/step; "
          f"{again:.2f} ms re-evaluating the points")
    for key, ms in sorted(parts.items()):
        print(f"  {key[:90]}: {ms:.3f} ms a launch (profiler)")
    for who, names, cyc in (("thread 0, channels", VJP_CHANNEL, c[:half]),
                            ("thread 32, points", VJP_POINTS, c[half:])):
        n = max(cyc[-1], 1)
        total = sum(cyc[:-1])
        print(f" {who}: {total / n:.0f} cycles/step over {n} observed steps")
        for name, v in zip(names, cyc):
            print(f"  {name:24s} {v / n:9.0f} cycles/step  {100.0 * v / max(total, 1):5.1f}%")


def main(argv) -> int:
    if argv[:1] == ["--kernel"]:
        if argv[1:2] != ["vjp"]:
            raise SystemExit("--kernel takes vjp")
        steps = int(argv[2]) if len(argv) > 2 else 16_000
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip()
        print("card:", smi)
        _build.library()
        lib = _build.library("libnsgp_probe_vjp", (_build._CSRC / "fused_adf_vjp_f32.cu",
                                                   _build._CSRC / "adf_info.cu"),
                             ("-DNSGP_CLOCK_PROBE",))
        probe_vjp(lib, steps)
        return 0
    t_head = int(argv[0]) if argv else 20_000
    t_mix = int(argv[1]) if len(argv) > 1 else 4_000
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print("card:", smi)
    _build.library()  # the shipped library, for adf_launch_shape
    lib = _build.library("libnsgp_probe", (_build._CSRC / "fused_adf_mb_f32.cu",
                                           _build._CSRC / "adf_info.cu"),
                         ("-DNSGP_CLOCK_PROBE",))
    dev = torch.device("cuda")
    model, params, y = cs.bench_inputs(torch.float32, dev)
    probe("headline", lib, model, stack_params([params]), y[None], t_head)
    models, plist, y_mix, _ = cs.mixture_inputs(torch.float32, dev, t_mix)
    jm, jp, _ = mixture.join_models(models, plist, lik=cs.MIX_LIK)
    probe("mixture", lib, jm, stack_params([jp]), y_mix[None], t_mix)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
