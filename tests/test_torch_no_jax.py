"""The port stands alone: importing and running ``nsgp_tpu_torch`` loads no
jax and no ``nsgp_tpu``; ``chip_smoke.py`` refuses to run without a card or
outside a checkout, and imports neither package."""

import ast
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import sys
import numpy as np
import torch
import nsgp_tpu_torch
from nsgp_tpu_torch import convert
from nsgp_tpu_torch.apps import missing_data, source_sep
from nsgp_tpu_torch.inference import batched, registry
from nsgp_tpu_torch.inference.ep import EPConfig, ep_infer
from nsgp_tpu_torch.models import mixture
from nsgp_tpu_torch.models.gtnmf import GTNMFModel, sample_prior, stack_params
from nsgp_tpu_torch.ops import (_build, bscan, cubature, fused_kalman, kalman, kernels, moments,
                                pscan, ssm)
from nsgp_tpu_torch.utils import device, metrics, precision

model, params = convert.load_trained(
    "results/trained/music/trained_piano_matern32.npz", device="cpu", dtype=torch.float64)
y, _, _ = sample_prior(torch.Generator().manual_seed(0), model, params, 64)
for backend in ("seq", "fused"):
    r = ep_infer(model, params, y, None, EPConfig(ep_itts=2, backend=backend), device="cpu")
    assert torch.isfinite(r.nlZ).all()
r = ep_infer(model, params, y, None, EPConfig(ep_itts=2, parallel=True, chunk=16), device="cpu")
assert torch.isfinite(r.nlZ).all()
ssm_ = model.build_ssm(params)
tt = torch.rand(40, ssm_.num_channels, dtype=torch.float64)
blocked = fused_kalman.fused_fwd_blocked_plain(tt, tt, ssm_.A, ssm_.Q, ssm_.Pinf, ssm_.H, chunk=16)
filtered = bscan.blocked_filter_with_sites(ssm_, kalman.Sites(tt, tt), 16)
assert torch.allclose(blocked[0].reshape(40, -1), filtered[0], atol=1e-9)
assert torch.isfinite(blocked[0]).all()
mask = missing_data.make_gap_mask(64, [(20, 8)])
paramsB = stack_params([params, params])
g = missing_data.fill_gaps_batch(model, paramsB, torch.stack([y, y]), torch.stack([mask, mask]),
                                 n_samples=4, device="cpu", ep_itts=2, backend="fused")
assert torch.isfinite(g.rmse_gaps).all() and g.result.nlZ.shape == (2, 2)
small = [convert.load_trained(f"results/trained/source_sep/trained_011PFNOM_M{n}_exp.npz",
                              device="cpu", dtype=torch.float64) for n in (60, 64)]
models, plist = zip(*small)
jm, jp, sl = mixture.join_models(models, plist, lik=1e-4)
assert (jm.D, jm.N) == (32, 6) and len(sl.sub) == 2
r = registry.infer("ep", model, params, y[:16], None, device="cpu", ep_itts=1)
assert torch.isfinite(metrics.rmse(r.Eft, torch.zeros_like(r.Eft))).all()
try:
    device.resolve_device(None)
    assert torch.cuda.is_available()
except RuntimeError:
    pass
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "nsgp_tpu"))
print("LOADED", bad)
sys.exit(1 if bad else 0)
"""


def _run(args, cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=300)


def test_port_imports_and_runs_without_jax():
    p = _run(["-c", _PROBE], ROOT)
    assert p.returncode == 0, p.stdout + p.stderr
    assert "LOADED []" in p.stdout


def test_chip_smoke_imports_no_jax():
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    roots = {n.split(".")[0] for n in names}
    assert not roots & {"jax", "jaxlib", "nsgp_tpu"}, roots


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_fails_without_card_or_checkout(where, tmp_path):
    """Run here (no CUDA device) from the checkout, and from a directory
    holding nothing but the script: both exit non-zero with no result."""
    if where == "alone":
        shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    else:
        cwd = ROOT
    p = _run(["chip_smoke.py"], cwd)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout and '"kernels"' not in p.stdout
