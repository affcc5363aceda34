"""Port parity: cubature, kernels -> state space, block SSM, GT-NMF params.

Same inputs (numpy, float64) through ``nsgp_tpu`` and ``nsgp_tpu_torch``;
tolerance 1e-12 relative unless stated (the two run the same float64
arithmetic; matrix exponentials differ in algorithm, Pade in JAX vs
Taylor in torch, at ~1e-15).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsgp_tpu.models import gtnmf as jg
from nsgp_tpu.ops import cubature as jcub
from nsgp_tpu.ops import kernels as jker
from nsgp_tpu.ops import ssm as jssm
from nsgp_tpu.pretrain import pipeline
from nsgp_tpu_torch import convert
from nsgp_tpu_torch.models import gtnmf as tg
from nsgp_tpu_torch.ops import cubature as tcub
from nsgp_tpu_torch.ops import kernels as tker
from nsgp_tpu_torch.ops import ssm as tssm
from torch_threads import one_torch_thread  # noqa: F401

RTOL = 1e-12
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAINED = os.path.join(ROOT, "results", "trained", "music", "trained_piano_matern32.npz")
F64 = torch.float64


def _close(t, j, rtol=RTOL, atol=1e-13):
    np.testing.assert_allclose(t.detach().cpu().numpy(), np.asarray(j), rtol=rtol, atol=atol)


@pytest.mark.parametrize("p,n,method", [(3, 2, "symmetric"), (5, 3, "symmetric"),
                                        (7, 3, "symmetric"), (9, 2, "symmetric"),
                                        (9, 3, "symmetric"), (5, 2, "gh")])
def test_unit_sigma_points_match(p, n, method):
    w_t, x_t = tcub.unit_sigma_points(p, n, method)
    w_j, x_j = jcub.unit_sigma_points(p, n, method)
    np.testing.assert_array_equal(w_t, w_j)
    np.testing.assert_array_equal(x_t, x_j)


@pytest.mark.parametrize("name", sorted(tker.KERNELS))
def test_kernel_to_ss_matches(name):
    ss_t = tker.get_kernel(name)(torch.tensor(1.7, dtype=F64), torch.tensor(23.0, dtype=F64))
    ss_j = jker.get_kernel(name)(jnp.asarray(1.7), jnp.asarray(23.0))
    for a, b in zip(ss_t, ss_j):
        _close(a, b)
    assert tker.kernel_state_dim(name) == jker.kernel_state_dim(name)


def _params(D, N, seed=0):
    rng = np.random.default_rng(seed)
    return dict(lik=np.asarray(0.05), sub_var=rng.uniform(0.5, 1.5, D),
                sub_len=rng.uniform(20.0, 80.0, D), omega=rng.uniform(0.1, 2.0, D),
                mod_var=rng.uniform(1.0, 2.0, N), mod_len=rng.uniform(300.0, 600.0, N),
                W=rng.uniform(0.2, 1.0, (D, N)))


@pytest.mark.parametrize("k1,k2,disc", [("matern32", "matern52", "stationary"),
                                        ("matern32", "matern32", "stationary"),
                                        ("exp", "matern52", "matrix_fraction"),
                                        ("matern52", "exp", "stationary")])
def test_build_modulator_ssm_matches(k1, k2, disc):
    p = _params(3, 2)
    args = [p[k] for k in ("sub_var", "sub_len", "omega", "mod_var", "mod_len")]
    s_t = tssm.build_modulator_ssm(*[torch.tensor(a) for a in args], kernel1=k1,
                                   kernel2=k2, discretization=disc)
    s_j = jssm.build_modulator_ssm(*[jnp.asarray(a) for a in args], kernel1=k1,
                                   kernel2=k2, discretization=disc)
    for f in ("F", "LQcLT", "H", "Pinf", "A", "Q", "pad_eye"):
        _close(getattr(s_t, f), getattr(s_j, f), atol=1e-12)
    assert (s_t.D, s_t.N) == (s_j.D, s_j.N)
    for a, b in zip(tssm.dense(s_t), jssm.dense(s_j)):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=1e-12)


def test_flat_log_roundtrip_matches():
    p = _params(4, 3, seed=1)
    jp = jg.GTNMFParams(**{k: jnp.asarray(v) for k, v in p.items()})
    tp = convert.params_from_numpy(p, device="cpu", dtype=F64)
    w_j = jp.to_flat_log()
    w_t = tp.to_flat_log()
    _close(w_t, w_j)
    back_t = tg.GTNMFParams.from_flat_log(w_t, 4, 3)
    back_j = jg.GTNMFParams.from_flat_log(w_j, 4, 3)
    for k in tg.PARAM_NAMES:
        _close(getattr(back_t, k), getattr(back_j, k))
        _close(getattr(back_t, k), p[k])


def test_params_module_moves_and_casts():
    tp = convert.params_from_numpy(_params(3, 2), device="cpu", dtype=F64)
    assert sorted(name for name, _ in tp.named_buffers()) == sorted(tg.PARAM_NAMES)
    t32 = tp.to(torch.float32)
    assert all(b.dtype == torch.float32 for b in t32.buffers())
    assert (t32.D, t32.N) == (3, 2)
    ps = tg.per_subband_params(0.1, np.ones(4), np.full(4, 30.0), np.linspace(0.1, 1, 4),
                               np.ones(4), np.full(4, 300.0))
    pj = jg.per_subband_params(0.1, jnp.ones(4), jnp.full(4, 30.0), jnp.linspace(0.1, 1, 4),
                               jnp.ones(4), jnp.full(4, 300.0))
    _close(ps.W, pj.W)


def test_load_trained_matches_pipeline():
    m_t, p_t = convert.load_trained(TRAINED, device="cpu")
    m_j, p_j = pipeline.load_trained(TRAINED)
    assert tuple(m_t) == tuple(m_j)
    for k in tg.PARAM_NAMES:
        _close(getattr(p_t, k), getattr(p_j, k), rtol=0, atol=0)
    # the full-width model (D=16, N=3) assembles identically
    s_t, s_j = m_t.build_ssm(p_t), m_j.build_ssm(p_j)
    for f in ("H", "Pinf", "A", "Q", "pad_eye"):
        _close(getattr(s_t, f), getattr(s_j, f), atol=1e-12)


def test_sample_prior_seeded_and_consistent():
    tp = convert.params_from_numpy(_params(3, 2), device="cpu", dtype=F64)
    model = tg.GTNMFModel(D=3, N=2, variant="sq")
    y1, sub, g = tg.sample_prior(torch.Generator().manual_seed(4), model, tp, 300)
    y2, _, _ = tg.sample_prior(torch.Generator().manual_seed(4), model, tp, 300)
    assert y1.shape == (300,) and sub.shape == (300, 3) and g.shape == (300, 2)
    assert torch.equal(y1, y2) and bool(torch.isfinite(y1).all())
    # y = sum_d sub_d * sqrt(W link(g))_d, the generative model's observation
    amps = torch.sqrt(torch.logaddexp(g, torch.zeros_like(g)) @ tp.W.T)
    torch.testing.assert_close(y1, (sub * amps).sum(-1), rtol=1e-12, atol=1e-12)
