"""Port parity: joint mixture models and source separation, float64 on the CPU.

- ``join_models``: values, slices and the ``lik`` default equal the JAX
  function exactly; mismatched kernels raise.
- ``source_signals``: the plug-in path matches JAX to 1e-12; the Monte-Carlo
  path is reproducible from its generator's seed and agrees with the JAX MC
  mean within 5 standard errors of the difference (the two draw different
  random numbers).
- ``separate`` on two toy sources against JAX ``separate(engine="ep",
  backend="pallas")`` with ``n_samples=0``: atol 1e-8 on sources and SNR.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsgp_tpu.apps import source_sep as jsep
from nsgp_tpu.models import mixture as jmix
from nsgp_tpu.models.gtnmf import GTNMFModel as JModel
from nsgp_tpu.models.gtnmf import GTNMFParams as JParams
from nsgp_tpu.models.gtnmf import sample_prior as j_sample_prior
from nsgp_tpu_torch import convert
from nsgp_tpu_torch.apps import source_sep as tsep
from nsgp_tpu_torch.models import mixture as tmix
from nsgp_tpu_torch.models.gtnmf import GTNMFModel
from torch_threads import one_torch_thread  # noqa: F401

T = 128


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _toy(D, N, seed, variant="amp"):
    rng = np.random.default_rng(seed)
    jm = JModel(D=D, N=N, kernel1="matern32", kernel2="matern52", p_cubature=5,
                variant=variant)
    jp = JParams(lik=jnp.asarray(0.03 + 0.01 * seed), sub_var=jnp.linspace(0.5, 1.5, D),
                 sub_len=jnp.linspace(30.0, 90.0, D), omega=jnp.linspace(0.3, 1.4, D) + 0.05 * seed,
                 mod_var=jnp.full((N,), 1.5), mod_len=jnp.linspace(250.0, 450.0, N),
                 W=jnp.asarray(rng.uniform(0.2, 1.0, (D, N))))
    return jm, jp


def _port(jm, jp):
    return GTNMFModel(*jm), convert.params_from_numpy(
        {k: np.asarray(v) for k, v in jp._asdict().items()}, device="cpu", dtype=torch.float64)


@pytest.fixture(scope="module")
def sources():
    """Two toy sources (different sizes), their JAX prior samples, the mix."""
    (m1, p1), (m2, p2) = _toy(2, 1, 5), _toy(3, 2, 6)
    y1 = np.array(j_sample_prior(jax.random.PRNGKey(7), m1, p1, T=T)[0])
    y2 = np.array(j_sample_prior(jax.random.PRNGKey(8), m2, p2, T=T)[0])
    return [m1, m2], [p1, p2], np.stack([y1, y2], -1)


@pytest.mark.parametrize("lik", [None, 1e-4])
def test_join_models_matches_jax(sources, lik):
    jms, jps, _ = sources
    jm, jp, jsl = jmix.join_models(jms, jps, lik=lik)
    tm, tp, tsl = tmix.join_models(*zip(*[_port(m, p) for m, p in zip(jms, jps)]), lik=lik)
    assert tuple(tm) == tuple(jm) and (tm.D, tm.N) == (5, 3)
    assert tsl.sub == jsl.sub == ((0, 2), (2, 5)) and tsl.mod == jsl.mod == ((0, 1), (1, 3))
    for k, v in jp._asdict().items():
        np.testing.assert_array_equal(_np(getattr(tp, k)), np.asarray(v), err_msg=k)
    assert float(tp.lik) == (1e-4 if lik else float(np.mean([0.08, 0.09])))
    assert tp.W.shape == (5, 3) and float(tp.W[:2, 1:].abs().max()) == 0.0


def test_join_models_refuses_mismatched_kernels(sources):
    jms, jps, _ = sources
    (m1, p1), (m2, p2) = (_port(m, p) for m, p in zip(jms, jps))
    for other in (m2._replace(kernel1="exp"), m2._replace(link="exp"),
                  m2._replace(variant="sq")):
        with pytest.raises(ValueError, match="share kernels"):
            tmix.join_models([m1, other], [p1, p2])


@pytest.mark.parametrize("variant", ["amp", "sq"])
def test_source_signals_plug_in_and_monte_carlo(variant):
    (m1, p1), (m2, p2) = _toy(2, 1, 5, variant), _toy(3, 2, 6, variant)
    jm, jp, jsl = jmix.join_models([m1, m2], [p1, p2])
    tm, tp, tsl = tmix.join_models(*zip(*[_port(m1, p1), _port(m2, p2)]))
    rng = np.random.default_rng(3)
    Eft = rng.normal(size=(40, 8))
    Var = rng.uniform(0.01, 0.2, size=(40, 8))
    plug_j = jmix.source_signals(jm, jp, jsl, jnp.asarray(Eft))
    plug_t = tmix.source_signals(tm, tp, tsl, torch.tensor(Eft))
    np.testing.assert_allclose(_np(plug_t), np.asarray(plug_j), rtol=1e-12, atol=1e-12)
    # no generator or no variances: still the plug-in path, as in JAX
    np.testing.assert_array_equal(
        _np(tmix.source_signals(tm, tp, tsl, torch.tensor(Eft), torch.tensor(Var), None, 50)),
        _np(plug_t))

    n = 4000
    mc = lambda seed: _np(tmix.source_signals(
        tm, tp, tsl, torch.tensor(Eft), torch.tensor(Var),
        torch.Generator().manual_seed(seed), n))
    mc_t = mc(11)
    np.testing.assert_array_equal(mc_t, mc(11))  # same seed, same draw
    assert np.abs(mc_t - mc(12)).max() > 0
    mc_j = np.asarray(jmix.source_signals(jm, jp, jsl, jnp.asarray(Eft), jnp.asarray(Var),
                                          jax.random.PRNGKey(0), n))
    # per-sample spread of a source's signal, from an independent numpy draw
    z = Eft[None, :, :5] + np.sqrt(Var[None, :, :5]) * rng.normal(size=(n, 40, 5))
    g = Eft[None, :, 5:] + np.sqrt(Var[None, :, 5:]) * rng.normal(size=(n, 40, 3))
    a = np.logaddexp(g, 0.0) @ np.asarray(jp.W).T
    if variant == "sq":
        a = np.sqrt(np.maximum(a, 1e-12))
    c = z * a
    sd = np.stack([c[..., lo:hi].sum(-1).std(0) for lo, hi in jsl.sub], -1)
    se_diff = np.sqrt(2.0) * sd / np.sqrt(n)
    assert np.all(np.abs(mc_t - mc_j) <= 5.0 * se_diff)


def test_separate_matches_jax_pallas(sources):
    jms, jps, parts = sources
    ymix = parts.sum(-1)
    kw = dict(ep_itts=3, moment_chunk=64, s_chunk=4, ep_fraction=0.75, damping=(0.1,))
    r_j = jsep.separate(jms, jps, jnp.asarray(ymix), engine="ep",
                        true_sources=jnp.asarray(parts), n_samples=0, mixture_lik=1e-3,
                        backend="pallas", pallas_block=64, **kw)
    tms, tps = zip(*[_port(m, p) for m, p in zip(jms, jps)])
    r_t = tsep.separate(tms, tps, torch.tensor(ymix), engine="ep",
                        true_sources=torch.tensor(parts), n_samples=0, mixture_lik=1e-3,
                        device="cpu", backend="fused", **kw)
    assert r_t.sources.shape == (T, 2) and r_t.snr.shape == (2,)
    np.testing.assert_allclose(_np(r_t.sources), np.asarray(r_j.sources), atol=1e-8)
    np.testing.assert_allclose(_np(r_t.snr), np.asarray(r_j.snr), atol=1e-8)
    np.testing.assert_allclose(_np(r_t.result.nlZ), np.asarray(r_j.result.nlZ), rtol=1e-9)
    # the reference keeps the BF=1 axis on the sites of this path; so does the port
    assert r_t.result.sites.ttau.shape == r_j.result.sites.ttau.shape == (1, T, 8)
    assert r_t.result.Eft.shape == (T, 8)


def test_separate_through_the_registry(sources):
    """Any other engine/backend goes through ``registry.infer``; without
    true sources there is no SNR; the MC read-out defaults to seed 0.  The
    default engine is IHGP, held against JAX's ``separate()`` (rtol 1e-8)."""
    jms, jps, parts = sources
    tms, tps = zip(*[_port(m, p) for m, p in zip(jms, jps)])
    y = torch.tensor(parts.sum(-1)[:48])
    r = tsep.separate(tms, tps, y, engine="ep", device="cpu", ep_itts=2, backend="seq",
                      n_samples=8)
    r2 = tsep.separate(tms, tps, y, engine="ep", device="cpu", ep_itts=2, backend="seq",
                       n_samples=8, generator=torch.Generator().manual_seed(0))
    assert r.snr is None and r.sources.shape == (48, 2)
    assert r.result.sites.ttau.shape == (48, 8)
    np.testing.assert_array_equal(_np(r.sources), _np(r2.sources))
    # the default engine, IHGP, against JAX's separate() with its defaults
    r_t = tsep.separate(tms, tps, y, device="cpu", ep_itts=2, n_samples=0)
    r_j = jsep.separate(jms, jps, jnp.asarray(_np(y)), ep_itts=2, unroll=1, n_samples=0)
    assert r_t.sources.shape == (48, 2) and r_t.result.Eft.shape == (48, 8)
    np.testing.assert_allclose(_np(r_t.sources), np.asarray(r_j.sources), rtol=1e-8,
                               atol=1e-8 * np.abs(np.asarray(r_j.sources)).max())
    np.testing.assert_allclose(_np(r_t.result.nlZ), np.asarray(r_j.result.nlZ), rtol=1e-8)
