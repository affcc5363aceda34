"""Time the filter and smoother kernels (K1 ``fused_fwd``, K2 ``fused_bwd``) on
the card, at the three shapes the paths of ``chip_smoke.py`` give them.

    python nsgp_tpu_torch/tools/time_kalman.py [--sweep]

float32, random sites from ``chip_smoke.random_sites``, CUDA events, mean of
5 runs after a warm-up:

    single   T=100 000, C=19  (D=16, N=3, matern32/matern52, bs=4)
    batch    T=53 248,  C=190 (the ten trained music models, bs=4)
    mixture  T=16 000,  C=57  (three trained source models joined, bs=3)

``--sweep`` also times every chunk length from 32 to 512 and one chunk over
all T (the sequential pass) through the wrappers' ``_chunk``, beside the
wrapper's own choice.

The script imports the checkout it lies in, so a copy placed in an unpacked
older commit times that commit (without ``--sweep`` there): run parent,
change, change, parent one after the other on one card to compare two
versions; ``tools/time_adf.py`` does the same for K3, K4 and the three
end-to-end calls.  Prints one ``TIME`` line per number with the card's name
and power limit.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from nsgp_tpu_torch.models import mixture  # noqa: E402
from nsgp_tpu_torch.models.gtnmf import stack_params  # noqa: E402
from nsgp_tpu_torch.ops import fused_kalman as fk  # noqa: E402
from nsgp_tpu_torch.ops.ssm import flatten_files  # noqa: E402


def kalman_args(ssm, T, seed):
    """(K1's arguments, K2's arguments) for T steps of random sites; K2
    smooths the kernel's own filtered trajectory."""
    dt_, dev = ssm.A.dtype, ssm.A.device
    tt, tn = (torch.tensor(x, dtype=dt_, device=dev)
              for x in cs.random_sites(T, ssm.num_channels, seed))
    fwd_args = (tt, tn, ssm.A, ssm.Q, ssm.Pinf, ssm.H)
    pad = torch.diagonal(ssm.pad_eye, dim1=-2, dim2=-1)
    return fwd_args, (*fk.fused_fwd(*fwd_args), ssm.A, ssm.Q, pad)


def shapes(dev):
    """{name: (flat model, T, seed)} as phases 1, 5 and 6 of chip_smoke.py."""
    model, params, _ = cs.bench_inputs(torch.float32, dev)
    cmodel, cparamsB, cyB, _, _, _ = cs.corpus_inputs(torch.float32, dev)
    models, plist, _, _ = cs.mixture_inputs(torch.float32, dev, 16)
    jm, jp, _ = mixture.join_models(models, plist, lik=cs.MIX_LIK)
    return {
        "single": (model.build_ssm(params), cs.T_MAIN, 2),
        "batch": (flatten_files(cmodel.build_ssm_batch(cparamsB)), cyB.shape[1], 5),
        "mixture": (flatten_files(jm.build_ssm_batch(stack_params([jp]))), cs.T_MIX, 6),
    }


def main(argv) -> int:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    say = lambda what, v: print(f"TIME {ROOT.name} {what}: {v} ms on {smi}", flush=True)
    for name, (ssm, T, seed) in shapes(dev).items():
        fwd_args, bwd_args = kalman_args(ssm, T, seed)
        C, bs = ssm.H.shape
        where = f"{name} T={T} C={C} bs={bs}"
        say(f"K1 fused_fwd {where}", round(cs.cuda_ms(lambda: fk.fused_fwd(*fwd_args), 5), 3))
        say(f"K2 fused_bwd {where}", round(cs.cuda_ms(lambda: fk.fused_bwd(*bwd_args), 5), 3))
        if "--sweep" in argv:
            own = fk.chunk_length(T, C)
            for L in (32, 64, 128, 256, 512, T):
                tag = f"{where} chunk={L}" + (" (the wrapper's choice)" if L == own else "") \
                    + (" (one chunk: sequential)" if L == T else "")
                reps = 1 if L == T else 5
                say(f"K1 fused_fwd {tag}",
                    round(cs.cuda_ms(lambda: fk.fused_fwd(*fwd_args, _chunk=L), reps), 3))
                say(f"K2 fused_bwd {tag}",
                    round(cs.cuda_ms(lambda: fk.fused_bwd(*bwd_args, _chunk=L), reps), 3))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
