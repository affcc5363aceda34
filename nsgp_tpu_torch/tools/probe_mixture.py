"""Time the mixture path at a given length on the card.

    python -m nsgp_tpu_torch.tools.probe_mixture [T]      (default 96 000,
    the reference's test excerpt, experiments/source_sep.py:42)

Runs ``separate(engine="ep", backend="fused", s_chunk=256, moment_chunk=64,
ep_itts=3)`` over the three trained source models on the seeded synthetic
mixture of ``chip_smoke.py`` in float32, once to warm up and once timed, and
prints the wall time, the launch counts, the energies and the card's name
and power limit.  Too long for ``chip_smoke.py``; kept for PERF.md.
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import chip_smoke as cs  # noqa: E402
from nsgp_tpu_torch.apps.source_sep import separate  # noqa: E402
from nsgp_tpu_torch.ops import fused_kalman as fk  # noqa: E402


def main(argv) -> int:
    T = int(argv[0]) if argv else 96_000
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    models, plist, y_mix, parts = cs.mixture_inputs(torch.float32, torch.device("cuda"), T)
    run = lambda: separate(models, plist, y_mix, engine="ep", true_sources=parts, n_samples=20,
                           mixture_lik=cs.MIX_LIK, **cs.MIX_KW)
    run()
    fk.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    r = res.result
    ok = bool(torch.isfinite(r.nlZ).all() and torch.isfinite(r.Eft).all()
              and (r.Varft > 0).all())
    print(f"separate T={T} f32 3 sweeps: {dt:.2f} s; launches "
          f"{ {fn.__name__: fn.launches for fn in fk.WRAPPERS} }; nlZ={r.nlZ.tolist()}; "
          f"snr_db={res.snr.tolist()}; finite and positive: {ok}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB; on {smi}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
