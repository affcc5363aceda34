"""Port parity: hyperparameter learning, HMC/VI and the engine registry,
float64 on the CPU.

- ``Transform`` round trip and box bounds, against JAX's on the same params;
- ``fit_hyperparams`` (3 Adam steps on the ADF energy) against JAX's:
  energies and learned params at rtol 1e-6 (torch's Adam is optax.adam's
  update; the two differ in rounding only);
- ``make_log_post`` and its gradient against JAX's (rtol 1e-9), and the
  port's leapfrog against one written here on ``jax.grad`` of JAX's log
  posterior, from the same momentum;
- ``hmc_sample`` / ``vi_fit``: shapes, finiteness, the same bits from the
  same seed, and the flat order of ``jax.flatten_util.ravel_pytree``;
- ``registry``: ``energy``, the ported engines and the refusals.

One toy model and one JAX compile per function (``unroll=1``).
"""

import jax
import jax.flatten_util
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsgp_tpu.inference import hmc as jhmc
from nsgp_tpu.inference import learn as jlearn
from nsgp_tpu.models.gtnmf import GTNMFModel as JModel
from nsgp_tpu.models.gtnmf import GTNMFParams as JParams
from nsgp_tpu.models.gtnmf import sample_prior as j_sample_prior
from nsgp_tpu_torch.convert import params_from_numpy
from nsgp_tpu_torch.inference import ep as tep
from nsgp_tpu_torch.inference import giekf as tgk
from nsgp_tpu_torch.inference import hmc as thmc
from nsgp_tpu_torch.inference import ihgp as tih
from nsgp_tpu_torch.inference import learn as tlearn
from nsgp_tpu_torch.inference import registry
from nsgp_tpu_torch.models.gtnmf import GTNMFModel
from torch_threads import one_torch_thread  # noqa: F401

D, N, T = 3, 2, 64
# the hmc_hypers experiment's boxes, with W on the log scale
SPECS = {"lik": (1e-4, 0.1), "sub_var": "fixed", "sub_len": "fixed", "omega": "fixed",
         "mod_var": (0.5, 8.0), "mod_len": (50.0, 800.0), "W": "log"}
SORTED = ("W", "lik", "mod_len", "mod_var")  # ravel_pytree's key order


@pytest.fixture(scope="module")
def toy():
    jm = JModel(D=D, N=N, kernel1="matern32", kernel2="matern52", p_cubature=7)
    jp = JParams(lik=jnp.asarray(1e-2), sub_var=jnp.ones((D,)),
                 sub_len=jnp.linspace(40.0, 120.0, D), omega=jnp.linspace(0.3, 2.2, D),
                 mod_var=jnp.full((N,), 2.0), mod_len=jnp.linspace(150.0, 300.0, N),
                 W=jax.random.uniform(jax.random.PRNGKey(0), (D, N), minval=0.2, maxval=1.0))
    y = np.asarray(j_sample_prior(jax.random.PRNGKey(1), jm, jp, T=T)[0])
    tp = params_from_numpy({k: np.asarray(v) for k, v in jp._asdict().items()}, device="cpu",
                           dtype=torch.float64)
    return jm, jp, GTNMFModel(*jm), tp, y


@pytest.fixture(scope="module")
def log_posts(toy):
    """(JAX log posterior over the flat vector, its jitted value_and_grad,
    the port's log posterior, flat u, port unravel)."""
    jm, jp, model, tp, y = toy
    tf_j = jlearn.Transform(SPECS)
    lp_j = jhmc.make_log_post(jlearn.make_energy_fn(jm, jnp.asarray(y), ep_itts=1, unroll=1),
                              tf_j, jp)
    flat_j, unravel_j = jax.flatten_util.ravel_pytree(tf_j.to_unconstrained(jp))
    logp_j = lambda q: lp_j(unravel_j(q))
    tf_t = tlearn.Transform(SPECS)
    lp_t = thmc.make_log_post(tlearn.make_energy_fn(model, torch.tensor(y), device="cpu"), tf_t,
                              tp)
    flat_t, unravel_t = thmc.ravel(tf_t.to_unconstrained(tp))
    np.testing.assert_allclose(flat_t.numpy(), np.asarray(flat_j), rtol=1e-14)
    return logp_j, jax.jit(jax.value_and_grad(logp_j)), lp_t, flat_t, unravel_t


def test_transform_round_trip_and_bounds(toy):
    jm, jp, model, tp, y = toy
    tf_t, tf_j = tlearn.Transform(SPECS), jlearn.Transform(SPECS)
    u_t, u_j = tf_t.to_unconstrained(tp), tf_j.to_unconstrained(jp)
    assert set(u_t) == set(u_j) == set(SORTED)
    for g in u_t:
        np.testing.assert_allclose(u_t[g].numpy(), np.asarray(u_j[g]), rtol=1e-12, err_msg=g)
    back = tf_t.to_params(u_t, tp)
    for g in tlearn.GROUPS:
        np.testing.assert_allclose(getattr(back, g).numpy(), getattr(tp, g).numpy(), rtol=1e-10)
    assert getattr(back, "omega") is tp.omega  # fixed groups pass through
    for u in ({g: torch.full_like(v, x) for g, v in u_t.items()} for x in (60.0, -60.0)):
        p = tf_t.to_params(u, tp)
        for g, spec in SPECS.items():
            if isinstance(spec, tuple):
                x = getattr(p, g)
                assert bool(((x >= spec[0]) & (x <= spec[1])).all()), g
    # a value outside its box is clipped into the interior before the logit
    wide = tlearn.GTNMFParams(*(x.clone() for x in tp.leaves()))
    wide.mod_var.fill_(100.0)
    u = tf_t.to_unconstrained(wide)["mod_var"]
    assert bool(torch.isfinite(u).all())
    np.testing.assert_allclose(tf_t.to_params({"mod_var": u}, tp).mod_var.numpy(), 8.0, rtol=1e-5)


def test_fit_hyperparams_matches_jax(toy):
    jm, jp, model, tp, y = toy
    fit_j = jlearn.fit_hyperparams(jm, jp, jnp.asarray(y), specs=SPECS, steps=3,
                                   learning_rate=1e-2, ep_itts=1, unroll=1)
    fit_t = tlearn.fit_hyperparams(model, tp, torch.tensor(y), specs=SPECS, steps=3,
                                   learning_rate=1e-2, device="cpu", ep_itts=1)
    np.testing.assert_allclose(fit_t.energies.numpy(), np.asarray(fit_j.energies), rtol=1e-6)
    assert fit_t.final_energy.item() == fit_t.energies[-1].item()
    for g in tlearn.GROUPS:
        np.testing.assert_allclose(getattr(fit_t.params, g).numpy(),
                                   np.asarray(getattr(fit_j.params, g)), rtol=1e-6, err_msg=g)
    assert not fit_t.params.W.requires_grad
    # energies[0] is the energy at the initial point (the loss before update 0)
    e0 = tep.ep_energy(model, tp, torch.tensor(y), None, tep.EPConfig(ep_itts=1), device="cpu")
    assert fit_t.energies[0].item() == e0.item()


def test_fit_hyperparams_takes_an_lbfgs_closure(toy):
    jm, jp, model, tp, y = toy
    lbfgs = lambda ps: torch.optim.LBFGS(ps, lr=0.5, max_iter=3)
    fit = tlearn.fit_hyperparams(model, tp, torch.tensor(y[:32]), specs=SPECS, steps=2,
                                 optimizer=lbfgs, device="cpu")
    assert fit.energies.shape == (2,) and bool(torch.isfinite(fit.energies).all())
    assert fit.energies[1] < fit.energies[0]


def test_log_post_and_gradient_match_jax(log_posts):
    logp_j, vg_j, lp_t, flat_t, unravel_t = log_posts
    v_j, g_j = vg_j(jnp.asarray(flat_t.numpy()))
    v_t, g_t = thmc._value_and_grad(lambda q: lp_t(unravel_t(q)), flat_t)
    np.testing.assert_allclose(v_t.item(), float(v_j), rtol=1e-10)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-9,
                               atol=1e-12 * np.abs(np.asarray(g_j)).max())


def test_leapfrog_matches_jax(log_posts):
    """From the same (q, p): three leapfrog steps of the port against the JAX
    package's scheme written here on jax.grad of its log posterior."""
    logp_j, vg_j, lp_t, flat_t, unravel_t = log_posts
    dim = flat_t.shape[0]
    p0 = np.random.default_rng(4).normal(size=dim)
    eps, n = 0.01, 3
    grad_j = lambda q: vg_j(q)[1]
    q, p = jnp.asarray(flat_t.numpy()), jnp.asarray(p0)
    p = p + 0.5 * eps * grad_j(q)
    for _ in range(n - 1):
        q = q + eps * p
        p = p + eps * grad_j(q)
    q = q + eps * p
    lp1, g1 = vg_j(q)
    p = p + 0.5 * eps * g1
    q_t, p_t, lp_t1, _ = thmc.leapfrog(lambda x: lp_t(unravel_t(x)), flat_t, torch.tensor(p0),
                                       eps, n)
    np.testing.assert_allclose(q_t.numpy(), np.asarray(q), rtol=1e-10)
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p), rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(lp_t1.item(), float(lp1), rtol=1e-10)


def test_hmc_and_vi_shapes_seeds_and_order(toy, log_posts):
    jm, jp, model, tp, y = toy
    _, _, _, flat_t, unravel_t = log_posts
    u0 = unravel_t(flat_t)
    tf = tlearn.Transform(SPECS)
    lp_t = thmc.make_log_post(tlearn.make_energy_fn(model, torch.tensor(y[:24]), device="cpu"),
                              tf, tp)
    cfg = thmc.HMCConfig(n_samples=3, n_warmup=2, n_leapfrog=2)
    run = lambda seed: thmc.hmc_sample(torch.Generator().manual_seed(seed), lp_t, u0, cfg,
                                       n_chains=2)
    a, b = run(0), run(0)
    dim = flat_t.shape[0]
    assert a.samples.shape == (2, 3, dim) and a.accept_rate.shape == (2,)
    assert a.step_size.shape == (2,)
    for x in (a.samples, a.accept_rate, a.step_size):
        assert bool(torch.isfinite(x).all())
    assert torch.equal(a.samples, b.samples) and torch.equal(a.step_size, b.step_size)
    assert not torch.equal(a.samples[0], a.samples[1])  # chains draw their own noise
    # samples[..., j] follows the sorted keys: W (D*N), lik, mod_len (N), mod_var (N)
    assert list(a.unravel(a.samples[0, 0])) == list(SORTED)
    offsets = np.cumsum([0, D * N, 1, N, N])
    for g, lo, hi in zip(SORTED, offsets[:-1], offsets[1:]):
        np.testing.assert_array_equal(a.unravel(a.samples[1, 2])[g].reshape(-1).numpy(),
                                      a.samples[1, 2, lo:hi].numpy())
    v1 = thmc.vi_fit(torch.Generator().manual_seed(3), lp_t, u0, steps=3, n_mc=2)
    v2 = thmc.vi_fit(torch.Generator().manual_seed(3), lp_t, u0, steps=3, n_mc=2)
    assert v1.mean.shape == v1.log_std.shape == (dim,) and v1.elbo_trace.shape == (3,)
    assert bool(torch.isfinite(v1.elbo_trace).all()) and bool(torch.isfinite(v1.mean).all())
    assert torch.equal(v1.mean, v2.mean) and torch.equal(v1.elbo_trace, v2.elbo_trace)
    assert list(v1.unravel(v1.mean)) == list(SORTED)


def test_log_jacobian_matches_jax(toy):
    jm, jp, model, tp, y = toy
    u_j = jlearn.Transform(SPECS).to_unconstrained(jp)
    u_t = tlearn.Transform(SPECS).to_unconstrained(tp)
    np.testing.assert_allclose(thmc._log_jacobian(tlearn.Transform(SPECS), u_t).item(),
                               float(jhmc._log_jacobian(jlearn.Transform(SPECS), u_j)),
                               rtol=1e-12)


def test_registry_energy_and_engines(toy):
    jm, jp, model, tp, y = toy
    y_t = torch.tensor(y[:32])
    infer_fn, energy_fn, cfg_cls = registry.get_engine("ep")
    assert (infer_fn, energy_fn, cfg_cls) == (tep.ep_infer, tep.ep_energy, tep.EPConfig)
    assert registry.get_engine("giekf") == (tgk.giekf_infer, tgk.giekf_energy, tgk.GIEKFConfig)
    e = registry.energy("ep", model, tp, y_t, device="cpu", ep_itts=2)
    e0 = tep.ep_energy(model, tp, y_t, None, tep.EPConfig(ep_itts=2), device="cpu")
    ec = registry.energy("ep", model, tp, y_t, config=tep.EPConfig(ep_itts=2), device="cpu")
    assert e.item() == e0.item() == ec.item()
    eg = registry.energy("giekf", model, tp, y_t, device="cpu")
    assert eg.item() == tgk.giekf_energy(model, tp, y_t, device="cpu").item()
    # IHGP is ported: its energy through the registry, and training through it
    assert registry.get_engine("ihgp") == (tih.ihgp_infer, tih.ihgp_energy, tih.IHGPConfig)
    ei = registry.energy("ihgp", model, tp, y_t, device="cpu")
    assert ei.item() == tih.ihgp_energy(model, tp, y_t, device="cpu").item()
    fit_i = tlearn.fit_hyperparams(model, tp, y_t, engine="ihgp", specs=SPECS, steps=1,
                                   device="cpu")
    assert fit_i.energies.shape == (1,) and fit_i.energies[0].item() == ei.item()
    with pytest.raises(ValueError, match="unknown engine"):
        tlearn.make_energy_fn(model, y_t, engine="ekf")
    # GIEKF trains through the same loop
    fit = tlearn.fit_hyperparams(model, tp, y_t, engine="giekf", specs=SPECS, steps=2,
                                 learning_rate=1e-2, device="cpu")
    assert bool(torch.isfinite(fit.energies).all())
