"""The port stands alone: importing and running ``nsgp_tpu_torch`` (inference,
the pretraining pipeline, denoising, the device mesh and the experiment
drivers among it, one driver run at a toy size) loads no jax and no
``nsgp_tpu``; ``chip_smoke.py`` refuses to run without a card or
outside a checkout, and imports neither package."""

import ast
import os
import shutil
import subprocess
import sys

import pytest
from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import sys


class _Blocked:  # importing jax, jaxlib or the JAX package raises in this process
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "nsgp_tpu"):
            raise ImportError(f"{name} is blocked here")
        return None


sys.meta_path.insert(0, _Blocked())
import numpy as np
import torch
import nsgp_tpu_torch
from nsgp_tpu_torch import convert
from nsgp_tpu_torch.apps import missing_data, source_sep
from nsgp_tpu_torch.inference import batched, giekf, hmc, ihgp, learn, registry
from nsgp_tpu_torch.inference.ep import EPConfig, ep_infer
from nsgp_tpu_torch.models import mixture
from nsgp_tpu_torch.models.gtnmf import GTNMFModel, GTNMFParams, sample_prior, stack_params
from nsgp_tpu_torch.ops import (_build, bscan, cubature, dare, fused_kalman, kalman, kernels,
                                moments, pscan, ssm)
from nsgp_tpu_torch.utils import device, metrics, precision

model, params = convert.load_trained(
    "results/trained/music/trained_piano_matern32.npz", device="cpu", dtype=torch.float64)
y, _, _ = sample_prior(torch.Generator().manual_seed(0), model, params, 64)
for backend in ("seq", "fused"):
    r = ep_infer(model, params, y, None, EPConfig(ep_itts=2, backend=backend), device="cpu")
    assert torch.isfinite(r.nlZ).all()
for chunk in (16, 0):
    r = ep_infer(model, params, y, None, EPConfig(ep_itts=2, parallel=True, chunk=chunk,
                                                  jitter=1e-9), device="cpu")
    assert torch.isfinite(r.nlZ).all()
for kw in ({}, {"parallel": True, "chunk": 24}, {"parallel": True, "chunk": 0}):
    r = ihgp.ihgp_infer(model, params, y[:40], None, ihgp.IHGPConfig(ep_itts=2, **kw),
                        device="cpu")
    assert torch.isfinite(r.nlZ).all() and (r.Varft > 0).all()
assert torch.isfinite(registry.energy("ihgp", model, params, y[:12], device="cpu"))
leaves = {k: v.clone().requires_grad_(True) for k, v in params.named_buffers()}
e = ihgp.ihgp_energy(model, GTNMFParams(**leaves), y[:12], device="cpu")  # K5's and K8's twins
assert all(torch.isfinite(g).all() for g in torch.autograd.grad(e, list(leaves.values())))
assert torch.isfinite(dare.dare_filter(torch.eye(2) * 0.9, torch.ones(2), torch.eye(2), 0.1)).all()
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
specs = {"lik": "fixed", "sub_var": "fixed", "omega": "fixed"}
fit = learn.fit_hyperparams(model, params, y[:12], specs=specs, steps=2, device="cpu")
assert fit.energies.shape == (2,) and torch.isfinite(fit.energies).all()
lp = hmc.make_log_post(learn.make_energy_fn(model, y[:8], device="cpu"), learn.Transform(specs),
                       params)
u0 = learn.Transform(specs).to_unconstrained(params)
h = hmc.hmc_sample(torch.Generator().manual_seed(0), lp, u0, hmc.HMCConfig(1, 1, 2), n_chains=1)
v = hmc.vi_fit(torch.Generator().manual_seed(0), lp, u0, steps=1, n_mc=1)
assert torch.isfinite(h.samples).all() and torch.isfinite(v.elbo_trace).all()
e = registry.energy("giekf", model, params, y[:12], device="cpu")
assert torch.isfinite(e) and torch.isfinite(giekf.giekf_infer(model, params, y[:12], None,
                                                             device="cpu").Eft).all()
from nsgp_tpu_torch.apps import denoise
from nsgp_tpu_torch.pretrain import ar2, filterbank, gppad, nmf, pipeline, segp, spectral
from nsgp_tpu_torch.utils import audio, speech_quality, stoi
ys = torch.tensor(np.sin(0.4 * np.arange(512)) + 0.3 * np.random.default_rng(0).normal(size=512))
fit = spectral.fit_probstft(ys, 3, num_levels=1, min_win=64, max_win=64, steps_per_level=5,
                            device="cpu")
fb = filterbank.build_filterbank(fit.sigma2, fit.lengthscales("exp"), fit.omega, noise=0.1,
                                 device="cpu")
assert torch.isfinite(filterbank.steady_filterbank(fb, ys, device="cpu").lml)
A = torch.rand(64, 3, dtype=torch.float64, generator=torch.Generator().manual_seed(0)) + 0.1
assert torch.isfinite(nmf.nmf_fp(A, 2, 5, 2, device="cpu").cost)
tm = pipeline.train_gtnmf_fixed_params(
    ys, D=3, N=2, kernel1="exp", fs=1000.0, device="cpu",
    filterbank_kwargs=dict(num_levels=2, min_win=64, max_win=128, steps_per_level=5))
dn = denoise.denoise(tm.model, tm.params, ys[:64], 0.1, y_clean=ys[:64], n_samples=2,
                     device="cpu", ep_itts=2, backend="fused")
assert torch.isfinite(dn.snr_out) and torch.isfinite(speech_quality.fw_seg_snr(ys, ys * 0.9, 8000))
from nsgp_tpu_torch import experiments
from nsgp_tpu_torch.experiments import (denoising, filterbank_demo, hmc_hypers, hmc_sbc,
                                        nonstationary_demo, protocol, synthetic, textures_ihgp,
                                        toy_demo, train_corpus, train_hyperopt)
from nsgp_tpu_torch.experiments import missing_data as md_driver
from nsgp_tpu_torch.experiments import source_sep as ss_driver
res = synthetic.run(T=24, ep_itts=1, device="cpu", engine_kwargs={"giekf": {"g_iter": 1}})
assert all(np.isfinite(res[e]["rmse_sig"]) for e in ("ep", "ihgp", "giekf"))
assert md_driver.engine_config("ep", 20, device="cpu")["ep_itts"] == 20
from nsgp_tpu_torch.experiments import figures, scaling_dryrun, speech_fit_probe
from nsgp_tpu_torch.parallel import collectives
from nsgp_tpu_torch.parallel import mesh as pmesh
assert [c for c, _ in figures.aggregates_data()] == ["music", "speech"]
assert speech_fit_probe._gap_mask("speech1_male", 900).shape == (900,)
assert collectives.mesh_axis("") is None and callable(pmesh.make_train_step)
assert scaling_dryrun.EP_ITTS == 2
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
    """Run Python in a child with no PYTHONPATH and, like the fixture in this
    process, one intra-op thread."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
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
