"""Time the two ADF kernels and the three paths that run them, on the card.

    python nsgp_tpu_torch/tools/time_adf.py [--kernels-only]

Times, on the inputs and shapes of ``chip_smoke.py``, float32:
K3 ``fused_adf`` at T=100 000 (D=16, N=3, 77 sigma points), K4
``fused_adf_mb`` at batch width (BF=10, T=53 248) and at mixture width
(BF=1, D=48, N=9, 3973 sigma points, T=16 000) with CUDA events, then (unless
``--kernels-only``) the end-to-end metrics: s/sweep of ``ep_infer``, s per
``fill_gaps_batch`` call, s per ``separate`` call, each after a warm-up.

The script imports the checkout it lies in, so a copy placed in an unpacked
older commit times that commit: run parent, change, change, parent one after
the other on one card to compare two versions.  Prints one ``TIME`` line per
number with the card's name and power limit.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from nsgp_tpu_torch.apps.missing_data import fill_gaps_batch  # noqa: E402
from nsgp_tpu_torch.apps.source_sep import separate  # noqa: E402
from nsgp_tpu_torch.inference.ep import EPConfig, ep_infer  # noqa: E402
from nsgp_tpu_torch.models import mixture  # noqa: E402
from nsgp_tpu_torch.models.gtnmf import stack_params  # noqa: E402


def main(argv) -> int:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    say = lambda what, v, unit: print(f"TIME {ROOT.name} {what}: {v} {unit} on {smi}", flush=True)

    model, params, y = cs.bench_inputs(torch.float32, dev)
    mask = torch.ones(cs.T_MAIN, dtype=torch.bool, device=dev)
    sites = cs.random_sites(cs.T_MAIN, cs.D + cs.N, seed=2)
    k3 = cs.single_cases(model, params, y, mask, sites, timing_only=True)["fused_adf"][0]
    say("K3 fused_adf T=100000", round(cs.cuda_ms(k3, 3), 2), "ms")

    cmodel, cparamsB, cyB, cmaskB, cgapsB, _ = cs.corpus_inputs(torch.float32, dev)
    k4b, _ = cs.adf_mb_case(cmodel, cparamsB, cyB, cmaskB, 0)
    say("K4 fused_adf_mb batch BF=10 T=53248", round(cs.cuda_ms(k4b, 3), 2), "ms")

    models, plist, y_mix, parts = cs.mixture_inputs(torch.float32, dev, cs.T_MIX)
    jm, jp, _ = mixture.join_models(models, plist, lik=cs.MIX_LIK)
    k4m, _ = cs.adf_mb_case(jm, stack_params([jp]), y_mix[None],
                            torch.ones_like(y_mix[None]) > 0, 256)
    say("K4 fused_adf_mb mixture S=3973 T=16000", round(cs.cuda_ms(k4m, 1), 2), "ms")
    if "--kernels-only" in argv:
        return 0

    cfg = EPConfig(ep_itts=cs.EP_ITTS, backend="fused", moment_chunk=8192)
    single = lambda: ep_infer(model, params, y, None, cfg)
    single()
    runs = [cs.host_s(single)[1] for _ in range(3)]
    say("headline s/sweep", f"{np.mean(runs) / cs.EP_ITTS:.4f} (runs {[round(r, 4) for r in runs]})",
        "s")
    gap_kw = dict(engine="ep", n_samples=20, metric_gapsB=cgapsB, ep_itts=cs.EP_ITTS,
                  backend="fused", **cs.CORPUS_KW)
    batch = lambda: fill_gaps_batch(cmodel, cparamsB, cyB, cmaskB,
                                    generator=torch.Generator().manual_seed(0), **gap_kw)
    batch()
    runs = [cs.host_s(batch)[1] for _ in range(3)]
    say("s per batch call", f"{np.mean(runs):.3f} (runs {[round(r, 3) for r in runs]})", "s")
    mix = lambda: separate(models, plist, y_mix, engine="ep", true_sources=parts,
                           generator=torch.Generator(device=dev).manual_seed(0), n_samples=20,
                           mixture_lik=cs.MIX_LIK, **cs.MIX_KW)
    mix()
    runs = [cs.host_s(mix)[1] for _ in range(2)]
    say("s per mixture T=16000", f"{np.mean(runs):.3f} (runs {[round(r, 3) for r in runs]})", "s")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
