"""Port parity: the GIEKF engine (``inference/giekf.py``), float64 on the CPU.

- ``dense_model`` and ``_measurement`` (the link's derivative in closed form
  where JAX takes ``jax.grad``) against JAX's, and the measurement gradient
  against autograd;
- ``giekf_infer`` Eft / Varft / nll against JAX's at 1e-8 (relative to each
  output's max), with the pass gate at its default ``accept_tol=1e-3`` and
  off (-1), on a signal with a NaN gap;
- ``giekf_energy`` and its gradient per ``GTNMFParams`` leaf against
  ``jax.grad`` (1e-8), and a finite difference on the noise, as
  tests/test_giekf.py checks the JAX engine;
- the divergence guard: a negative noise variance makes S <= 0, so every
  observed update is rejected in both packages (the same count), the energy
  is NaN and the posterior stays finite; and tests/test_giekf.py's hard
  float32 configuration stays finite over 20 global passes (T cut from 1500
  to 200 for time: 20 passes of a Python loop).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsgp_tpu.inference import giekf as jg
from nsgp_tpu.models.gtnmf import GTNMFModel as JModel
from nsgp_tpu.models.gtnmf import GTNMFParams as JParams
from nsgp_tpu.models.gtnmf import sample_prior as j_sample_prior
from nsgp_tpu_torch.convert import params_from_numpy
from nsgp_tpu_torch.inference import giekf as tg
from nsgp_tpu_torch.models.gtnmf import PARAM_NAMES, GTNMFModel, GTNMFParams
from torch_threads import one_torch_thread  # noqa: F401

T = 100


def _toy(D=3, N=2, variant="amp", link="softplus"):
    """tests/test_giekf.py's toy."""
    jm = JModel(D=D, N=N, kernel1="matern32", kernel2="matern52", p_cubature=7, variant=variant,
                link=link)
    jp = JParams(lik=jnp.asarray(0.05), sub_var=jnp.linspace(0.5, 1.5, D),
                 sub_len=jnp.linspace(30.0, 90.0, D), omega=jnp.linspace(0.2, 1.2, D),
                 mod_var=jnp.full((N,), 1.5), mod_len=jnp.linspace(300.0, 500.0, N),
                 W=jax.random.uniform(jax.random.PRNGKey(0), (D, N), minval=0.2, maxval=1.0))
    return jm, jp


def _port(jp, dtype=torch.float64):
    return params_from_numpy({k: np.asarray(v) for k, v in jp._asdict().items()}, device="cpu",
                             dtype=dtype)


def _signal(jm, jp, gap=True):
    y = np.array(j_sample_prior(jax.random.PRNGKey(11), jm, jp, T=T)[0])
    if gap:
        y[30:42] = np.nan
    return y


def _rel(a, b):
    b = np.asarray(b)
    return np.abs(np.asarray(a) - b).max() / np.abs(b).max()


def test_dense_model_matches_jax():
    jm, jp = _toy()
    ssm_j = jm.build_ssm(jp)
    ssm_t = GTNMFModel(*jm).build_ssm(_port(jp))
    for a, b in zip(tg.dense_model(ssm_t), jg.dense_model(ssm_j)):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-12)


@pytest.mark.parametrize("variant,link", [("amp", "softplus"), ("amp", "exp"),
                                          ("sq", "softplus"), ("sq", "exp")])
def test_measurement_matches_jax_and_autograd(variant, link):
    jm, jp = _toy(variant=variant, link=link)
    f = np.random.default_rng(2).normal(size=5)
    yhat_j, dh_j = jg._measurement(jm, jp.W, jnp.asarray(f))
    ft = torch.tensor(f, requires_grad=True)
    yhat_t, dh_t = tg._measurement(GTNMFModel(*jm), _port(jp).W, ft)
    np.testing.assert_allclose(yhat_t.item(), float(yhat_j), rtol=1e-13)
    np.testing.assert_allclose(dh_t.detach().numpy(), np.asarray(dh_j), rtol=1e-12, atol=1e-14)
    (dh_ad,) = torch.autograd.grad(yhat_t, ft)
    np.testing.assert_allclose(dh_t.detach().numpy(), dh_ad.numpy(), rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("accept_tol", [1e-3, -1.0])
def test_giekf_infer_matches_jax(accept_tol):
    jm, jp = _toy()
    y = _signal(jm, jp)
    cfg = dict(g_iter=3, l_iter=5, accept_tol=accept_tol)
    r_j = jg.giekf_infer(jm, jp, jnp.asarray(y), None, jg.GIEKFConfig(**cfg))
    r_t = tg.giekf_infer(GTNMFModel(*jm), _port(jp), torch.tensor(y), None, tg.GIEKFConfig(**cfg),
                         device="cpu")
    for f in ("Eft", "Varft", "ms", "Ps", "nll"):
        a, b = getattr(r_t, f).numpy(), np.asarray(getattr(r_j, f))
        assert a.shape == b.shape, f
        assert _rel(a, b) <= 1e-8, (f, _rel(a, b))
    assert np.all(r_t.Varft.numpy() > 0)


def test_giekf_energy_and_gradient_match_jax():
    jm, jp = _toy(variant="sq")
    y = _signal(jm, jp)
    e_j, g_j = jax.value_and_grad(
        lambda p: jg.giekf_energy(jm, p, jnp.asarray(y), None, jg.GIEKFConfig()))(jp)
    leaves = {k: getattr(_port(jp), k).clone().requires_grad_(True) for k in PARAM_NAMES}
    model = GTNMFModel(*jm)
    e_t = tg.giekf_energy(model, GTNMFParams(**leaves), torch.tensor(y), device="cpu")
    grads = torch.autograd.grad(e_t, list(leaves.values()))
    np.testing.assert_allclose(e_t.item(), float(e_j), rtol=1e-10)
    for k, g in zip(PARAM_NAMES, grads):
        assert _rel(g.numpy(), getattr(g_j, k)) <= 1e-8, k
    # a central difference on the noise, as tests/test_giekf.py does for JAX
    eps = 1e-6
    shifted = lambda d: tg.giekf_energy(
        model, GTNMFParams(*((x + d) if n == "lik" else x for n, x in
                             zip(PARAM_NAMES, _port(jp).leaves()))), torch.tensor(y),
        device="cpu").item()
    np.testing.assert_allclose(grads[0].item(), (shifted(eps) - shifted(-eps)) / (2 * eps),
                               rtol=1e-4)


def test_divergence_guard_rejects_like_jax():
    """A negative noise variance (S = J P J' + sn2 < 0 at every observed
    step): each update is rejected and becomes a pure prediction, the same
    steps in both packages; the energy is NaN and the posterior finite."""
    jm, jp = _toy()
    y = _signal(jm, jp)
    bad_j = jp._replace(lik=jnp.asarray(-1e3))
    bad_t = _port(bad_j)
    model = GTNMFModel(*jm)
    A, Q, Pinf, Hd = jg.dense_model(jm.build_ssm(bad_j))
    mask = ~np.isnan(y)
    _, _, _, n_j = jg._filter(jm, bad_j.W, bad_j.lik, A, Q, Hd, jnp.asarray(np.nan_to_num(y)),
                              jnp.asarray(mask), jnp.zeros(A.shape[0]), Pinf, jg.GIEKFConfig(), 1)
    At, Qt, Pt, Hdt = tg.dense_model(model.build_ssm(bad_t))
    _, _, nll_t, n_t = tg._filter(model, bad_t.W, bad_t.lik, At, Qt, Hdt,
                                  torch.tensor(np.nan_to_num(y)), torch.tensor(mask),
                                  torch.zeros(At.shape[0], dtype=torch.float64), Pt, 1)
    assert int(n_t) == int(n_j) == int(mask.sum())
    assert nll_t.item() == 0.0  # rejected steps carry no NLL
    assert np.isnan(tg.giekf_energy(model, bad_t, torch.tensor(y), device="cpu").item())
    r = tg.giekf_infer(model, bad_t, torch.tensor(y), None, tg.GIEKFConfig(g_iter=2, l_iter=1),
                       device="cpu")
    assert bool(torch.isfinite(r.Eft).all()) and bool(torch.isfinite(r.Varft).all())


def test_giekf_f32_hard_config_stays_finite():
    """tests/test_giekf.py::test_giekf_f32_divergence_guard's configuration
    (near-zero noise, large NMF weights) in float32 over 20 global passes."""
    jm, jp = _toy(D=6, N=3)
    jp = jp._replace(lik=jnp.asarray(1e-7), W=10.0 * jp.W, mod_var=jnp.full((3,), 6.0))
    y = np.asarray(j_sample_prior(jax.random.PRNGKey(11), jm, jp, T=200)[0])
    r = tg.giekf_infer(GTNMFModel(*jm), _port(jp, torch.float32),
                       torch.tensor(y, dtype=torch.float32), None,
                       tg.GIEKFConfig(g_iter=20, l_iter=1), device="cpu")
    assert r.Eft.dtype == torch.float32
    assert bool(torch.isfinite(r.Eft).all()) and bool(torch.isfinite(r.Varft).all())
    assert np.isfinite(r.nll.item())


def test_giekf_needs_a_card_unless_asked_for_the_cpu():
    jm, jp = _toy(D=2, N=1)
    y = torch.zeros(8, dtype=torch.float64)
    r = tg.giekf_infer(GTNMFModel(*jm), _port(jp), y, None, tg.GIEKFConfig(g_iter=1),
                       device="cpu")
    assert r.Eft.device.type == "cpu" and r.Eft.shape == (8, 3)
    if not torch.cuda.is_available():
        for fn in (tg.giekf_infer, tg.giekf_energy):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                fn(GTNMFModel(*jm), _port(jp), y)
