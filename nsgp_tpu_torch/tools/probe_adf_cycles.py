"""Cycles per step, by phase, of the ADF kernels' shared step on the card.

    python -m nsgp_tpu_torch.tools.probe_adf_cycles [T_headline [T_mixture]]
    (defaults 20 000 and 4 000 steps)

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


def main(argv) -> int:
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
