"""K8's plain twin: the reverse of K5's steady ADF sweep, float64 on the CPU.

``fused_ihgp_adf_vjp_plain`` (a hand-written reverse loop, no autograd
inside) is held against ``torch.autograd.grad`` through
``fused_ihgp_adf_plain`` at rtol 1e-10, with seeded random cotangents on all
four float outputs (ms, lZ, ttau, tnu) and on lZ alone: 'amp' and 'sq',
softplus and exp, block sizes 2, 3 and 4, a NaN gap, a later pass of the
sequential form (the last step matched, fixed non-zero sites elsewhere, on
the unobserved steps too, a third of them exactly 0), and a 50-sigma outlier
that drives Z under its floor.  ``FusedIHGPADF`` passes ``gradcheck``;
``ihgp_energy`` reaches it (its forward and backward once a value and
gradient) and its gradient equals JAX's ``jax.grad`` at rtol 1e-7, and
``fit_hyperparams(engine="ihgp")`` equals JAX's at rtol 1e-6.

JAX runs ``unroll=1`` (the same values, a smaller compile); the signals are
seeded numpy draws.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsgp_tpu.inference import ihgp as jih
from nsgp_tpu.inference import learn as jlearn
from nsgp_tpu.models.gtnmf import GTNMFModel as JModel
from nsgp_tpu.models.gtnmf import GTNMFParams as JParams
from nsgp_tpu_torch.convert import params_from_numpy
from nsgp_tpu_torch.inference import ihgp as tih
from nsgp_tpu_torch.inference import learn as tlearn
from nsgp_tpu_torch.models.gtnmf import PARAM_NAMES, GTNMFModel, GTNMFParams
from nsgp_tpu_torch.ops import fused_ihgp as fih
from torch_threads import one_torch_thread  # noqa: F401

D, N = 3, 2
DIFF = ("A", "H", "first", "tab", "W", "sn2")
DAMP = 0.5


def _signal(rng, T):
    t = np.arange(T)
    env = lambda: 0.3 + np.abs(np.cumsum(rng.normal(size=T))) / np.sqrt(T)
    y = sum(env() * np.cos(om * t + rng.uniform(0, 2 * np.pi)) for om in (0.2, 0.7, 1.2))
    return y + 0.2 * rng.normal(size=T)


def _inputs(T, k1, k2, link, variant, case, seed=0, cfg=tih.IHGPConfig()):
    """(args, kw): K5's inputs on the CPU in float64, the differentiable ones
    under their names in ``args["diff"]``."""
    rng = np.random.default_rng(seed)
    model = GTNMFModel(D=D, N=N, kernel1=k1, kernel2=k2, link=link, variant=variant,
                       p_cubature=7)
    params = GTNMFParams(
        lik=np.float64(0.05), sub_var=np.linspace(0.5, 1.5, D),
        sub_len=np.linspace(20.0, 80.0, D), omega=np.linspace(0.2, 1.2, D),
        mod_var=np.full(N, 1.5), mod_len=np.linspace(300.0, 600.0, N),
        W=rng.uniform(0.2, 1.0, (D, N)),
    ).to(dtype=torch.float64, device="cpu")
    y = _signal(rng, T)
    obs = np.ones(T, bool)
    C = D + N
    tt = tn = np.zeros((T, C))
    match = np.ones(T, bool)
    if case in ("gap", "later"):
        obs[T // 3: T // 3 + 9] = False
    if case == "outlier":
        y[T // 2] = 50.0 * y.std()
    if case == "later":  # a later pass: fixed sites, a third exactly 0, the last re-matched
        tt = rng.uniform(0.0, 40.0, (T, C)) * (rng.uniform(size=(T, C)) > 0.33)
        tn = rng.normal(size=(T, C)) * tt
        match[:-1] = False
    ssm = model.build_ssm(params)
    tables = tih.build_tables(ssm, cfg, smoother=False)
    H = ssm.H
    tab = torch.cat([tables.Ph, tables.hPph[..., None]], dim=-1)
    first = torch.cat([(ssm.Pinf @ H[..., None])[..., 0],
                       torch.einsum("ci,cij,cj->c", H, ssm.Pinf, H)[:, None]], dim=-1)
    t = lambda x: torch.tensor(x)
    args = dict(y=t(np.where(obs, y, 0.0)), obs=t(obs), match=t(match), ttau=t(tt), tnu=t(tn),
                lk=fih.lookup_consts(tables.log_r),
                diff=dict(A=ssm.A, H=H, first=first, tab=tab, W=params.W, sn2=params.lik))
    return args, dict(mp=model.moment_params(), damp=DAMP)


def _call(fn, a, diff, *rest, **kw):
    d = diff
    return fn(a["y"], a["obs"], a["match"], a["ttau"], a["tnu"], d["A"], d["H"], d["first"],
              d["tab"], a["lk"], d["W"], d["sn2"], *rest, **kw)


# (k1, k2, link, variant, case, cotangents): bs 2 (matern32 pads exp), 3 and 4
CASES = [
    ("matern32", "exp", "softplus", "amp", "clean", "all"),
    ("matern32", "exp", "softplus", "amp", "clean", "lZ"),
    ("matern32", "matern52", "softplus", "sq", "gap", "all"),
    ("exp", "matern52", "exp", "amp", "gap", "all"),
    ("matern32", "matern52", "exp", "sq", "gap", "lZ"),
    ("matern32", "matern52", "softplus", "amp", "later", "all"),
    ("exp", "matern32", "exp", "sq", "later", "all"),
    ("matern32", "matern52", "softplus", "amp", "outlier", "all"),
    ("exp", "matern32", "softplus", "sq", "outlier", "lZ"),
]


@pytest.mark.parametrize("k1,k2,link,variant,case,cots", CASES)
def test_vjp_twin_matches_autograd_of_the_forward_twin(k1, k2, link, variant, case, cots):
    T = 64
    a, kw = _inputs(T, k1, k2, link, variant, case)
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in a["diff"].items()}
    outs = _call(fih.fused_ihgp_adf_plain, a, leaves, **kw)
    ms, idx, lZ, tt, tn = outs
    assert len(torch.unique(idx)) > 3  # the steps read many table rows
    if case == "outlier":  # the floor binds at the outlier, and only there
        assert lZ[T // 2].item() == pytest.approx(np.log(kw["mp"].z_floor), rel=1e-12)
    if case == "later":  # unobserved steps with non-zero sites: idx and next row differ
        gap = ~a["obs"]
        assert bool((tt[gap] > 0).any()) and bool((idx[gap] == idx.max()).all())
    rng = np.random.default_rng(7)
    floats = (0, 2, 3, 4) if cots == "all" else (2,)
    g_out = [torch.tensor(rng.normal(size=tuple(o.shape))) if i in floats else None
             for i, o in enumerate(outs)]
    used = [(o, g) for o, g in zip(outs, g_out) if g is not None]
    ref = torch.autograd.grad([o for o, _ in used], list(leaves.values()),
                              [g for _, g in used], allow_unused=True)
    got = _call(fih.fused_ihgp_adf_vjp_plain, a, a["diff"], ms.detach(), idx, tt.detach(),
                g_out[0], g_out[2], g_out[3], g_out[4], **kw)
    for name, x, r in zip(DIFF, got, ref):
        assert r is not None and x.shape == r.shape and x.dtype == r.dtype, name
        assert torch.isfinite(r).all() and r.abs().max() > 0, name
        np.testing.assert_allclose(x.numpy(), r.numpy(), rtol=1e-10,
                                   atol=1e-12 * r.abs().max().item(), err_msg=name)


def test_function_passes_gradcheck():
    """K5 then K8 as one Function, every differentiable input at once, on a
    short signal with a gap and a coarse grid (a finite difference must not
    move a site across a grid boundary)."""
    cfg = tih.IHGPConfig(grid_coarse=8, grid_fine=24)
    a, kw = _inputs(10, "matern32", "matern52", "softplus", "sq", "clean", cfg=cfg)
    a["obs"][4] = False
    a["y"][4] = 0.0
    leaves = [a["diff"][k].detach().clone().requires_grad_(True) for k in DIFF]

    def f(*xs):
        d = dict(zip(DIFF, xs))
        ms, _, lZ, tt, tn = _call(fih.fused_ihgp_adf_autograd, a, d, **kw)
        return ms, lZ, tt, tn

    assert torch.autograd.gradcheck(f, leaves, eps=1e-7, atol=1e-6, rtol=1e-5, fast_mode=True)


@pytest.fixture(scope="module")
def toy():
    jm = JModel(D=3, N=2, kernel1="matern32", kernel2="matern52", p_cubature=7)
    jp = JParams(lik=jnp.asarray(0.05), sub_var=jnp.linspace(0.5, 1.5, 3),
                 sub_len=jnp.linspace(30.0, 90.0, 3), omega=jnp.linspace(0.2, 1.2, 3),
                 mod_var=jnp.full((2,), 1.5), mod_len=jnp.asarray([300.0, 500.0]),
                 W=jax.random.uniform(jax.random.PRNGKey(0), (3, 2), minval=0.2, maxval=1.0))
    params = params_from_numpy({k: np.asarray(v) for k, v in jp._asdict().items()},
                               device="cpu", dtype=torch.float64)
    y = _signal(np.random.default_rng(42), 64)
    y[20:28] = np.nan
    return jm, jp, GTNMFModel(*jm), params, y


def _counted(monkeypatch):
    """Count the calls of the two twins that ``FusedIHGPADF`` runs on the CPU."""
    calls = {"forward": 0, "backward": 0}
    for key, name in (("forward", "fused_ihgp_adf_plain"),
                      ("backward", "fused_ihgp_adf_vjp_plain")):
        fn = getattr(fih, name)

        def run(*a, _fn=fn, _key=key, **k):
            calls[_key] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(fih, name, run)
    return calls


def test_ihgp_energy_runs_through_the_function_and_matches_jax(toy, monkeypatch):
    jm, jp, model, params, y = toy
    e_j, g_j = jax.value_and_grad(
        lambda p: jih.ihgp_energy(jm, p, jnp.asarray(y), None, jih.IHGPConfig(unroll=1)))(jp)
    calls = _counted(monkeypatch)
    leaves = {k: getattr(params, k).clone().requires_grad_(True) for k in PARAM_NAMES}
    e_t = tih.ihgp_energy(model, GTNMFParams(**leaves), torch.tensor(y), None, device="cpu")
    assert calls == {"forward": 1, "backward": 0}
    g_t = dict(zip(PARAM_NAMES, torch.autograd.grad(e_t, list(leaves.values()))))
    assert calls == {"forward": 1, "backward": 1}
    np.testing.assert_allclose(e_t.item(), float(e_j), rtol=1e-10)
    for k in PARAM_NAMES:
        ref = np.asarray(getattr(g_j, k))
        assert np.all(np.isfinite(ref)) and np.abs(ref).max() > 0, k
        np.testing.assert_allclose(g_t[k].numpy(), ref, rtol=1e-7,
                                   atol=1e-12 * np.abs(ref).max(), err_msg=k)


def test_fit_hyperparams_through_the_function_matches_jax(toy, monkeypatch):
    jm, jp, model, params, y = toy
    y = y[:48]
    specs = {"lik": "fixed", "omega": "fixed", "mod_len": (100.0, 1000.0)}
    fit_j = jlearn.fit_hyperparams(jm, jp, jnp.asarray(y), engine="ihgp", specs=specs, steps=2,
                                   learning_rate=1e-2, unroll=1)
    calls = _counted(monkeypatch)
    fit_t = tlearn.fit_hyperparams(model, params, torch.tensor(y), engine="ihgp", specs=specs,
                                   steps=2, learning_rate=1e-2, device="cpu", unroll=1)
    assert calls == {"forward": 2, "backward": 2}
    np.testing.assert_allclose(fit_t.energies.numpy(), np.asarray(fit_j.energies), rtol=1e-6)
    for g in tlearn.GROUPS:
        np.testing.assert_allclose(getattr(fit_t.params, g).numpy(),
                                   np.asarray(getattr(fit_j.params, g)), rtol=1e-6, err_msg=g)
