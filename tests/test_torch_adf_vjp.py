"""K7's plain twin: the reverse of K3's ADF sweep, float64 on the CPU.

``fused_adf_vjp_plain`` (a hand-written reverse loop, no autograd inside) is
held against ``torch.autograd.grad`` through ``fused_adf_plain`` with seeded
random cotangents on all five outputs (and on lZ alone) at rtol 1e-9: 'amp'
and 'sq', softplus and exp, a NaN gap, a 50-sigma outlier that drives Z under
its floor, block sizes 2 and 3.  ``FusedADF`` passes ``gradcheck``, and
``ep_energy`` reaches it for its sweep 1.  The energy and its gradient
against JAX are in ``test_torch_energy.py``.
"""

import numpy as np
import pytest
import torch

from nsgp_tpu_torch.inference import ep as tep
from nsgp_tpu_torch.models.gtnmf import GTNMFModel, GTNMFParams, sample_prior
from nsgp_tpu_torch.ops import fused_kalman as fk
from nsgp_tpu_torch.ops import kalman
from nsgp_tpu_torch.ops.moments import sigma_points
from torch_threads import one_torch_thread  # noqa: F401

D, N = 3, 2
DIFF = ("A", "Q", "Pinf", "H", "W", "sn2")


def _inputs(T, k1, k2, link, variant, case, seed=0):
    rng = np.random.default_rng(seed)
    model = GTNMFModel(D=D, N=N, kernel1=k1, kernel2=k2, link=link, variant=variant)
    params = GTNMFParams(
        lik=np.float64(0.05), sub_var=np.linspace(0.5, 1.5, D),
        sub_len=np.linspace(20.0, 80.0, D), omega=np.linspace(0.1, 1.0, D),
        mod_var=np.full(N, 1.5), mod_len=np.linspace(300.0, 600.0, N),
        W=rng.uniform(0.2, 1.0, (D, N)),
    ).to(dtype=torch.float64, device="cpu")
    y, _, _ = sample_prior(torch.Generator().manual_seed(seed + 1), model, params, T)
    obs = torch.ones(T, dtype=torch.float64)
    if case == "gap":
        obs[T // 3: T // 3 + 9] = 0.0
        y = torch.where(obs > 0, y, torch.zeros_like(y))
    elif case == "outlier":
        y = y.clone()
        y[T // 2] = 50.0 * y.std()
    ssm = model.build_ssm(params)
    mp = model.moment_params()
    wn, xi = sigma_points(mp, torch.float64, "cpu")
    diff = dict(A=ssm.A, Q=ssm.Q, Pinf=ssm.Pinf, H=ssm.H, W=params.W, sn2=params.lik)
    kw = dict(damp=0.5, link=link, variant=variant, z_floor=mp.z_floor)
    return y, obs, diff, xi, wn, kw


def _call(fn, y, obs, diff, xi, wn, *rest, **kw):
    return fn(y, obs, *(diff[k] for k in ("A", "Q", "Pinf", "H", "W")), xi, wn, diff["sn2"],
              *rest, **kw)


def _cotangents(outs, rng, which):
    return [torch.tensor(rng.normal(size=o.shape)) if i in which else None
            for i, o in enumerate(outs)]


# (k1, k2, link, variant, case, cotangents): bs 2 (matern32 pads exp) and 3
CASES = [
    ("matern32", "exp", "softplus", "amp", "clean", "all"),
    ("matern32", "matern52", "softplus", "sq", "clean", "all"),
    ("exp", "matern52", "exp", "amp", "gap", "all"),
    ("matern32", "matern52", "exp", "sq", "gap", "lZ"),
    ("matern32", "matern52", "softplus", "amp", "outlier", "all"),
    ("exp", "matern32", "softplus", "sq", "outlier", "lZ"),
]


@pytest.mark.parametrize("k1,k2,link,variant,case,cots", CASES)
def test_vjp_twin_matches_autograd_of_the_forward_twin(k1, k2, link, variant, case, cots):
    T = 96
    y, obs, diff, xi, wn, kw = _inputs(T, k1, k2, link, variant, case)
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in diff.items()}
    outs = _call(fk.fused_adf_plain, y, obs, leaves, xi, wn, **kw)
    if case == "outlier":  # the floor binds at the outlier, and only there
        assert outs[2][T // 2].item() == pytest.approx(np.log(kw["z_floor"]), rel=1e-12)
    which = range(5) if cots == "all" else (2,)
    g_out = _cotangents(outs, np.random.default_rng(7), which)
    used = [(o, g) for o, g in zip(outs, g_out) if g is not None]
    ref = torch.autograd.grad([o for o, _ in used], list(leaves.values()),
                              [g for _, g in used])
    fwd = [o.detach() for o in outs]
    got = _call(fk.fused_adf_vjp_plain, y, obs, diff, xi, wn, fwd[0], fwd[1], *g_out, **kw)
    for name, a, b in zip(DIFF, got, ref):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert torch.isfinite(b).all() and b.abs().max() > 0, name
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-9,
                                   atol=1e-12 * b.abs().max().item(), err_msg=name)


def test_function_passes_gradcheck():
    y, obs, diff, xi, wn, kw = _inputs(8, "matern32", "matern52", "softplus", "sq", "gap")
    obs[2] = 0.0
    leaves = [diff[k].detach().clone().requires_grad_(True) for k in DIFF]

    def f(A, Q, Pinf, H, W, sn2):
        return fk.FusedADF.apply(y, obs, A, Q, Pinf, H, W, xi, wn, sn2, kw)

    assert torch.autograd.gradcheck(f, leaves, eps=1e-6, atol=1e-7, rtol=1e-5,
                                    fast_mode=True)


def test_ep_energy_sweep_one_runs_through_the_function(monkeypatch):
    """On the CPU ``ep_energy``'s sweep 1 goes through ``FusedADF`` (its
    forward and backward once each), never through the sequential
    ``kalman.adf_filter``, which later sweeps still run."""
    calls = {"forward": 0, "backward": 0, "seq": 0}
    fwd, vjp, seq = fk.fused_adf_plain, fk.fused_adf_vjp_plain, kalman.adf_filter

    def counted(key, fn):
        def run(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return run

    monkeypatch.setattr(fk, "fused_adf_plain", counted("forward", fwd))
    monkeypatch.setattr(fk, "fused_adf_vjp_plain", counted("backward", vjp))
    monkeypatch.setattr(kalman, "adf_filter", counted("seq", seq))
    model = GTNMFModel(D=D, N=N, kernel1="matern32", kernel2="matern52")
    params = GTNMFParams(
        lik=np.float64(0.05), sub_var=np.ones(D), sub_len=np.linspace(20.0, 80.0, D),
        omega=np.linspace(0.1, 1.0, D), mod_var=np.full(N, 1.5),
        mod_len=np.linspace(300.0, 600.0, N), W=np.full((D, N), 0.5),
    ).to(dtype=torch.float64, device="cpu")
    y, _, _ = sample_prior(torch.Generator().manual_seed(3), model, params, 32)
    for itts, seq_calls in ((1, 0), (3, 1)):
        calls.update(forward=0, backward=0, seq=0)
        leaves = {k: v.clone().requires_grad_(True) for k, v in params.named_buffers()}
        e = tep.ep_energy(model, GTNMFParams(**leaves), y, None, tep.EPConfig(ep_itts=itts),
                          device="cpu")
        torch.autograd.grad(e, list(leaves.values()))
        assert calls == {"forward": 1, "backward": 1, "seq": seq_calls}, itts
