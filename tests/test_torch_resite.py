"""Where the EP re-site runs K9 (``inference/ep.py:_ep_resite``), on the CPU.

K9 (``ops/fused_kalman.py:fused_resite``, ``csrc/fused_resite.cuh``) runs
only on CUDA tensors, through ``FusedResite``, whose backward recomputes the
plain twin.  On CPU tensors the re-site is the plain path it was before the
kernel: ``_ep_resite`` is held here to a frozen copy of that path, bit for
bit, with or without autograd, and K9's launch counter stays 0.
``FusedResite``'s backward is held to the twin's own VJP, with the launch
stood in for by the twin.  The kernel itself is held to its plain twin on
the card (``tests/test_torch_cuda.py``, marker ``cuda``).  No JAX here.
"""

import numpy as np
import pytest
import torch

from nsgp_tpu_torch.inference import ep as ep_mod
from nsgp_tpu_torch.inference.ep import EPConfig, ep_energy
from nsgp_tpu_torch.models.gtnmf import PARAM_NAMES, GTNMFModel, GTNMFParams, sample_prior
from nsgp_tpu_torch.ops import fused_kalman as fk
from nsgp_tpu_torch.ops.kalman import Sites
from nsgp_tpu_torch.ops.moments import moments_chunked
from torch_threads import one_torch_thread  # noqa: F401

T = 40


def _frozen_resite(model, params, cfg, y, mask, mu, var, sites, damp, exclude_last=False):
    """The re-site as the port ran it before K9, frozen here as the yardstick."""
    if exclude_last:
        mask = mask.clone()
        mask[-1] = False
    frac = cfg.ep_fraction
    mp = model.moment_params()
    v_cav_raw = 1.0 / (1.0 / var - frac * sites.ttau)
    ok = (v_cav_raw > 0.0) & mask[:, None]
    v_cav = torch.where(ok, v_cav_raw, torch.ones_like(v_cav_raw))
    m_cav = torch.where(ok, v_cav_raw * (mu / var - frac * sites.tnu),
                        torch.zeros_like(v_cav_raw))
    lZ, dlZ, d2lZ = moments_chunked(mp, params.lik, y, m_cav, v_cav, params.W, frac,
                                    chunk=cfg.moment_chunk)
    lZ = torch.where(mask, lZ, torch.zeros_like(lZ))
    denom = 1.0 + d2lZ * v_cav
    ttau_prop = (1.0 - damp * frac) * sites.ttau + damp * (-d2lZ / denom)
    tnu_prop = (1.0 - damp * frac) * sites.tnu + damp * ((dlZ - m_cav * d2lZ) / denom)
    ttau = torch.where(ok, ttau_prop, sites.ttau)
    tnu = torch.where(ok, tnu_prop, sites.tnu)
    return Sites(torch.clamp_min(ttau, 0.0), tnu), lZ


def _model(link="softplus", variant="sq", pep=False):
    return GTNMFModel(D=3, N=2, kernel1="matern32", kernel2="matern52", link=link,
                      variant=variant, p_cubature=7, use_pep_const=pep)


def _params(requires_grad=False):
    rng = np.random.default_rng(3)
    p = GTNMFParams(lik=np.float64(0.05), sub_var=np.linspace(0.5, 1.5, 3),
                    sub_len=np.linspace(20.0, 80.0, 3), omega=np.linspace(0.1, 1.0, 3),
                    mod_var=np.full(2, 1.5), mod_len=np.linspace(300.0, 600.0, 2),
                    W=rng.uniform(0.2, 1.0, (3, 2))).to(dtype=torch.float64)
    if requires_grad:
        p = GTNMFParams(**{k: getattr(p, k).detach().requires_grad_(True) for k in PARAM_NAMES})
    return p


def _site_inputs(C, seed=0):
    """Marginals and sites of T steps with a masked run, a channel whose
    cavity variance is not positive, and an outlier under the Z floor."""
    rng = np.random.default_rng(seed)
    f = lambda x: torch.tensor(x, dtype=torch.float64)
    mu, var = f(rng.normal(size=(T, C)) * 0.5), f(rng.uniform(0.05, 1.5, (T, C)))
    tt, tn = f(rng.uniform(0.0, 2.0, (T, C))), f(rng.normal(size=(T, C)))
    tt[4, 1] = 50.0  # v_raw <= 0: the site is kept
    y = f(rng.normal(size=T))
    y[9] = 1e3  # every point's log-normaliser far below the floor
    mask = torch.ones(T, dtype=torch.bool)
    mask[12:18] = False
    y[12:18] = float("nan")
    return y, mask, mu, var, Sites(tt, tn)


def test_resite_on_cpu_is_the_frozen_plain_path():
    """The twin is ``_ep_resite``'s old body moved: one case, with 'exp'
    amplitudes, ``use_pep_const`` and ``exclude_last``, holds the move."""
    model, params = _model("exp", "amp", pep=True), _params()
    y, mask, mu, var, sites = _site_inputs(model.D + model.N)
    cfg = EPConfig(ep_fraction=0.75, moment_chunk=16)
    fk.reset_launches()
    got, lZ = ep_mod._ep_resite(model, params, cfg, y, mask, mu, var, sites, 0.3, True)
    ref, lZ_ref = _frozen_resite(model, params, cfg, y, mask, mu, var, sites, 0.3, True)
    assert torch.equal(got.ttau, ref.ttau) and torch.equal(got.tnu, ref.tnu)
    assert torch.equal(lZ, lZ_ref)
    assert fk.fused_resite.launches == 0


@pytest.mark.parametrize("grad_mode,leaf_grad", [(True, True), (False, True), (True, False)])
def test_resite_on_cpu_takes_the_plain_twin_under_autograd_or_not(monkeypatch, grad_mode,
                                                                   leaf_grad):
    """``_ep_resite`` always calls the wrapper; on CPU tensors the wrapper
    runs the plain twin, with or without autograd recording, and launches
    nothing.  Where autograd records, the sites carry its graph."""
    calls = []

    def spy(fn):
        def call(*a, **k):
            calls.append(fn.__name__)
            return fn(*a, **k)
        return call

    wrapper = fk.fused_resite
    monkeypatch.setattr(fk, "fused_resite", spy(wrapper))
    monkeypatch.setattr(fk, "fused_resite_plain", spy(fk.fused_resite_plain))
    model = _model()
    params = _params(requires_grad=leaf_grad)
    y, mask, mu, var, sites = _site_inputs(model.D + model.N)
    fk.reset_launches()
    with torch.set_grad_enabled(grad_mode):
        got, lZ = ep_mod._ep_resite(model, params, EPConfig(), y, mask, mu, var, sites, 0.5)
    assert calls == ["fused_resite", "fused_resite_plain"]
    assert wrapper.launches == 0
    assert got.tnu.requires_grad == lZ.requires_grad == (grad_mode and leaf_grad)


def _twin_as_kernel(mp, y, mask, mu, var, ttau, tnu, W, sn2, *, frac, damp):
    """Stands in for K9's launch on the CPU: the plain twin, as the kernel
    is, outside autograd."""
    with torch.no_grad():
        return fk.fused_resite_plain(mp, y, mask, mu, var, ttau, tnu, W, sn2, frac=frac,
                                     damp=damp)


@pytest.mark.parametrize("wrt", [("mu", "var", "ttau", "tnu", "W", "sn2"), ("W", "sn2"),
                                 ("ttau", "tnu")])
def test_fused_resite_backward_is_the_plain_twins_vjp(monkeypatch, wrt):
    """``FusedResite``'s backward recomputes the plain twin at the saved
    inputs: its gradients are the twin's own, bit for bit, for any set of
    inputs that need one, and the others get none."""
    monkeypatch.setattr(fk, "_resite_launch", _twin_as_kernel)
    model, params = _model("exp", "amp", pep=True), _params()
    y, mask, mu, var, sites = _site_inputs(model.D + model.N)
    y = torch.nan_to_num(y)  # as the entry points pass it: a masked step reads 0
    names = ("mu", "var", "ttau", "tnu", "W", "sn2")
    xs = [mu, var, sites.ttau, sites.tnu, params.W, params.lik]
    gs = [torch.randn(s, generator=torch.Generator().manual_seed(i), dtype=torch.float64)
          for i, s in enumerate(((T, 5), (T, 5), (T,)))]
    kw = dict(frac=0.75, damp=0.3)

    def grads(run):
        leaves = [x.detach().clone().requires_grad_(n in wrt) for x, n in zip(xs, names)]
        outs = run(*leaves)
        wanted = [x for x in leaves if x.requires_grad]
        return outs, torch.autograd.grad(outs, wanted, gs), leaves

    mp = model.moment_params()
    outs, got, leaves = grads(lambda *a: fk.FusedResite.apply(
        y, mask, *a, (mp, kw["frac"], kw["damp"], 16)))
    ref_outs, ref, _ = grads(lambda *a: fk.fused_resite_plain(mp, y, mask, *a, chunk=16, **kw))
    assert all(torch.equal(a.detach(), b.detach()) for a, b in zip(outs, ref_outs))
    assert len(got) == len(wrt) and all(torch.equal(a, b) for a, b in zip(got, ref))
    assert all(x.grad is None for x in leaves)


def test_ep_energy_through_fused_resite_equals_the_plain_path(monkeypatch):
    """``ep_energy``'s later sweeps with every re-site through
    ``FusedResite`` (K9's launch stood in for by the twin): value and
    gradient equal the CPU path's, bit for bit."""
    model = _model()
    params0 = _params()
    y, _, _ = sample_prior(torch.Generator().manual_seed(1), model, params0, T)
    y[20:25] = float("nan")
    cfg = EPConfig(ep_itts=3, ep_fraction=0.75, damping=(0.2,))

    def value_and_grad():
        params = _params(requires_grad=True)
        e = ep_energy(model, params, y, config=cfg, device="cpu")
        return [e.detach(), *torch.autograd.grad(e, [getattr(params, k) for k in PARAM_NAMES])]

    ref = value_and_grad()
    monkeypatch.setattr(fk, "_resite_launch", _twin_as_kernel)
    monkeypatch.setattr(fk, "fused_resite", lambda mp, y, mask, mu, var, ttau, tnu, W, sn2, *,
                        frac, damp, chunk: fk.FusedResite.apply(
                            y, mask, mu, var, ttau, tnu, W, sn2, (mp, frac, damp, chunk)))
    got = value_and_grad()
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
