"""What a GIEKF step costs on the card, one file and a batch of files.

    python -m nsgp_tpu_torch.tools.probe_giekf [T [BF]]

On the trained exp music models of ``chip_smoke.py`` phase 10 (D=16, N=3,
exp/matern52, dense m = 57), float32, at T (default 1024) with seeded
signals and no gaps: ``giekf_infer`` on one file with the engine's defaults
(g_iter=3, l_iter=5) and with the corpus grid's setting (g_iter=2,
l_iter=1), then, where the tree has it, ``giekf_infer_batch`` over BF files
(default 3) at the grid's setting; seconds and ms a step a pass, each
after one warm-up call, the card synchronised around each call, and the
CUDA kernels a step of one grid-setting call (``torch.profiler``).  Copy it
into an unpacked older commit to time that commit in the same call.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from nsgp_tpu_torch.convert import load_trained  # noqa: E402
from nsgp_tpu_torch.inference import batched, giekf  # noqa: E402
from nsgp_tpu_torch.models.gtnmf import stack_params  # noqa: E402

MODELS = Path(__file__).resolve().parents[2] / "results" / "trained" / "music"
FILES = ("cello", "guitar", "ocarina", "piano", "sax", "flute", "clarinet", "piccolo")


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def kernels(fn):
    """CUDA kernels launched by one call of ``fn``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages() if e.device_type.name == "CUDA")


def main():
    T = int(sys.argv[1]) if len(sys.argv) > 1 else 1024
    BF = int(sys.argv[2]) if len(sys.argv) > 2 else 3
    dev = torch.device("cuda")
    loaded = [load_trained(MODELS / f"trained_{n}_exp.npz", device=dev, dtype=torch.float32)
              for n in FILES[:BF]]
    model = loaded[0][0]
    rng = np.random.default_rng(0)
    yB = torch.tensor(rng.normal(size=(BF, T)), dtype=torch.float32, device=dev)
    grid = giekf.GIEKFConfig(g_iter=2, l_iter=1)
    for name, cfg in (("defaults", giekf.GIEKFConfig()), ("grid", grid)):
        one = lambda: giekf.giekf_infer(model, loaded[0][1], yB[0], None, cfg)
        one()
        _, s = timed(one)
        print(f"giekf_infer one file T={T} {name} (g_iter={cfg.g_iter}, l_iter={cfg.l_iter}) "
              f"f32: {s:.3f} s = {1e3 * s / (T * cfg.g_iter):.3f} ms a step a pass", flush=True)
    n = kernels(lambda: giekf.giekf_infer(model, loaded[0][1], yB[0], None, grid))
    print(f"giekf_infer one file grid: {n / (T * grid.g_iter):.1f} CUDA kernels a step a pass",
          flush=True)
    if hasattr(batched, "giekf_infer_batch"):
        pB = stack_params([p for _, p in loaded])
        many = lambda: batched.giekf_infer_batch(model, pB, yB, None, grid)
        many()
        _, s = timed(many)
        n = kernels(many)
        print(f"giekf_infer_batch BF={BF} T={T} grid f32: {s:.3f} s = "
              f"{1e3 * s / (T * grid.g_iter):.3f} ms a step a pass "
              f"({1e3 * s / (T * grid.g_iter * BF):.3f} a file); "
              f"{n / (T * grid.g_iter):.1f} CUDA kernels a step a pass", flush=True)


if __name__ == "__main__":
    main()
