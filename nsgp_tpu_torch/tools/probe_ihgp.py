"""What the IHGP engine costs on the card, stage by stage.

    python -m nsgp_tpu_torch.tools.probe_ihgp [T ...]

For the headline model of ``chip_smoke.py`` (D=16, N=3, matern32/matern52,
77 sigma points; its seeded signal), at each T (default 16 000) in float32
on the card: the DARE bank (``build_tables``: the first call, which loads
the card's solver libraries, then all tables and the forward tables alone),
sweep 1 (the sequential steady ADF filter, one launch of K5), the
later-sweep passes with fixed sites (the sequential filter that re-matches
the last site (K5), the sequential smoother (K6), the blocked filter and
smoother at chunk
2048, the one-level log-depth filter and smoother where T <= 20 000), and
the all-T re-site, each in s and sweep 1 also in us per step.  One JSON
line per T, after the card's name and power limit.  ``ihgp_energy``'s value
and gradient (K5 and its adjoint K8) is measured by ``chip_smoke.py``
phase 8f.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from chip_smoke import bench_inputs  # noqa: E402
from nsgp_tpu_torch.inference import ihgp  # noqa: E402
from nsgp_tpu_torch.ops.kalman import Sites  # noqa: E402

CFG = ihgp.IHGPConfig(ep_itts=3, damping=(0.1,), moment_chunk=8192)  # bench.py's ihgp-seq
CHUNK = 2048  # bench.py's ihgp-blocked
ONE_LEVEL_MAX_T = 20_000


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def probe(T: int, dev=torch.device("cuda")) -> dict:
    model, params, y = bench_inputs(torch.float32, dev)
    y = y[:T]
    mask = torch.ones(T, dtype=torch.bool, device=dev)
    with torch.no_grad():
        ssm = model.build_ssm(params)
        out = {"T": T}
        _, out["bank_first_call_s"] = timed(lambda: ihgp.build_tables(ssm, CFG))
        tables, out["bank_s"] = timed(lambda: ihgp.build_tables(ssm, CFG))
        _, out["bank_forward_only_s"] = timed(lambda: ihgp.build_tables(ssm, CFG, smoother=False))
        lik = (model.moment_params(), params.W, params.lik)
        zeros = torch.zeros((T, ssm.num_channels), dtype=y.dtype, device=dev)
        (ms, idx, _, sites), s1 = timed(lambda: ihgp._steady_filter_seq(
            ssm, tables, y, mask, Sites(zeros, zeros), *lik, CFG.damp(0), mask))
        out["sweep1_s"], out["sweep1_us_per_step"] = s1, 1e6 * s1 / T
        last = torch.zeros_like(mask)
        last[-1] = True
        _, out["seq_filter_s"] = timed(lambda: ihgp._steady_filter_seq(
            ssm, tables, y, mask, sites, *lik, CFG.damp(1), last))
        _, out["seq_smoother_s"] = timed(lambda: ihgp._steady_smoother(
            ssm, tables, ms, idx, parallel=False))
        (mb, ib), out["blocked_filter_s"] = timed(lambda: ihgp._steady_filter_blocked(
            ssm, tables, mask, sites, CHUNK))
        sm, out["blocked_smoother_s"] = timed(lambda: ihgp._steady_smoother_blocked(
            ssm, tables, mb, ib, CHUNK))
        if T <= ONE_LEVEL_MAX_T:
            (mp, ip), out["one_level_filter_s"] = timed(lambda: ihgp._steady_filter_parallel(
                ssm, tables, mask, sites))
            _, out["one_level_smoother_s"] = timed(lambda: ihgp._steady_smoother(
                ssm, tables, mp, ip, parallel=True))
        C, bs = ssm.H.shape
        Hm = (ssm.H[:, :, None] * torch.eye(C, device=dev)[:, None, :]).reshape(C * bs, C)
        mu, var = sm @ Hm, tables.hPSh[torch.arange(C, device=dev), ib]
        _, out["resite_s"] = timed(lambda: ihgp._resite(
            model.moment_params(), params, CFG, y, mask, mu, var, sites, CFG.damp(1)))
    return out


def main(argv) -> int:
    if not torch.cuda.is_available():
        raise SystemExit("probe_ihgp needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(smi.strip().splitlines()[0], flush=True)
    for T in [int(a) for a in argv] or [16_000]:
        print(json.dumps({"probe_ihgp": probe(T)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
