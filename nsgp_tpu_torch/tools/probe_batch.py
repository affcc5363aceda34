"""Where the batched path's time goes on the card.

    python -m nsgp_tpu_torch.tools.probe_batch

Runs ``fill_gaps_batch`` over the ten trained music models exactly as
``chip_smoke.py`` phase 5 does (BF=10, T=53 248, float32, 3 sweeps), then
prints: the wall time of a call; its stages timed one by one on the host
clock between synchronisations (model assembly, one re-site of all files,
the Monte-Carlo read-out); and a ``torch.profiler`` trace of one call
reduced to device-busy time, idle share and the heaviest device kernels.
If the profiler reports no device time it says so.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import chip_smoke as cs  # noqa: E402
from nsgp_tpu_torch.apps.missing_data import fill_gaps_batch, reconstruct_signal  # noqa: E402
from nsgp_tpu_torch.inference import ep as ep_mod  # noqa: E402
from nsgp_tpu_torch.inference.ep import EPConfig  # noqa: E402
from nsgp_tpu_torch.ops.kalman import Sites  # noqa: E402


def main() -> int:
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    model, pB, yB, maskB, gapsB, _ = cs.corpus_inputs(torch.float32, dev)
    BF, T = yB.shape
    kw = dict(engine="ep", n_samples=20, metric_gapsB=gapsB, ep_itts=3, backend="fused",
              **cs.CORPUS_KW)
    call = lambda: fill_gaps_batch(model, pB, yB, maskB,
                                   generator=torch.Generator().manual_seed(0), **kw)
    res, _ = cs.host_s(call)
    res, wall = cs.host_s(call)
    print(f"fill_gaps_batch BF={BF} T={T} f32: {wall:.3f} s per call on {smi}")

    rb = res.result
    cfg = EPConfig(ep_itts=3, backend="fused", **cs.CORPUS_KW)
    _, t_ssm = cs.host_s(lambda: model.build_ssm_batch(pB))
    _, t_resite = cs.host_s(lambda: [
        ep_mod._ep_resite(model, pB.select(b), cfg, yB[b], maskB[b], rb.Eft[b], rb.Varft[b],
                          Sites(rb.sites.ttau[b], rb.sites.tnu[b]), 0.1) for b in range(BF)])
    gens = [torch.Generator(device=dev).manual_seed(b) for b in range(BF)]
    _, t_mc = cs.host_s(lambda: [
        reconstruct_signal(model, pB.select(b), rb.Eft[b], rb.Varft[b], gens[b], 20)
        for b in range(BF)])
    print(f"stages: build_ssm_batch {t_ssm:.3f} s (once per call); one re-site of all files "
          f"{t_resite:.3f} s (twice per call); MC read-out {t_mc:.3f} s (once per call)")

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, traced = cs.host_s(call)
    rows = [e for e in prof.key_averages() if getattr(e, "device_time_total", 0) > 0]
    busy = sum(e.self_device_time_total for e in rows) / 1e6
    if busy == 0:
        print("torch.profiler reported no device time on this machine")
        return 0
    print(f"profiled call: {traced:.3f} s wall, device busy {busy:.3f} s "
          f"(idle share {1 - busy / traced:.2f})")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"  {e.self_device_time_total / 1e3:9.1f} ms  x{e.count:<6d} {e.key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
