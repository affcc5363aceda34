"""Where the single-signal path's time goes on the card.

    python -m nsgp_tpu_torch.tools.probe_single

Runs ``ep_infer(backend="fused")`` at the headline shape exactly as
``chip_smoke.py`` phase 2 does (D=16, N=3, T=100 000, float32, 3 sweeps),
then prints: the wall time of a call; its stages timed one by one on the
host clock between synchronisations (model assembly, the ADF sweep, one
filter and smoother pass, the observable marginals, one re-site of all T);
and a ``torch.profiler`` trace of one call reduced to device-busy time, idle
share and the heaviest device kernels.  If the profiler reports no device
time it says so.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import chip_smoke as cs  # noqa: E402
from nsgp_tpu_torch.inference import ep as ep_mod  # noqa: E402
from nsgp_tpu_torch.inference.ep import EPConfig, ep_infer  # noqa: E402
from nsgp_tpu_torch.ops import fused_kalman as fk  # noqa: E402
from nsgp_tpu_torch.ops import kalman  # noqa: E402


def main() -> int:
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    model, params, y = cs.bench_inputs(torch.float32, dev)
    cfg = EPConfig(ep_itts=cs.EP_ITTS, backend="fused", moment_chunk=8192)
    call = lambda: ep_infer(model, params, y, None, cfg)
    res, _ = cs.host_s(call)
    res, wall = cs.host_s(call)
    print(f"ep_infer fused T={cs.T_MAIN} f32 {cs.EP_ITTS} sweeps: {wall:.4f} s per call "
          f"({wall / cs.EP_ITTS:.4f} s/sweep) on {smi}")

    mask = torch.ones(cs.T_MAIN, dtype=torch.bool, device=dev)
    ssm, t_ssm = cs.host_s(lambda: model.build_ssm(params))
    (ms_f, Ps_f, _, sites), t_adf = cs.host_s(lambda: fk.adf_filter_fused(
        model.moment_params(), ssm, params.W, params.lik, y, mask, cfg.damp(0)))
    (ms, Ps), t_fb = cs.host_s(lambda: fk.filter_smoother_fused(ssm, sites))
    (mu, var), t_marg = cs.host_s(lambda: kalman.observable_marginals(ssm, ms, Ps))
    _, t_resite = cs.host_s(lambda: ep_mod._ep_resite(model, params, cfg, y, mask, mu, var,
                                                      sites, cfg.damp(1)))
    print(f"stages: build_ssm {t_ssm:.4f} s (once per call); ADF sweep K3 {t_adf:.4f} s (once); "
          f"filter + smoother K1, K2 {t_fb:.4f} s (twice, and K2 once more); observable "
          f"marginals {t_marg:.4f} s (three times); one re-site of all T {t_resite:.4f} s (twice)")

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, traced = cs.host_s(call)
    rows = [e for e in prof.key_averages() if getattr(e, "device_time_total", 0) > 0]
    busy = sum(e.self_device_time_total for e in rows) / 1e6
    if busy == 0:
        print("torch.profiler reported no device time on this machine")
        return 0
    print(f"profiled call: {traced:.4f} s wall, device busy {busy:.4f} s "
          f"(idle share {1 - busy / traced:.2f})")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  {e.self_device_time_total / 1e3:9.2f} ms  x{e.count:<6d} {e.key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
