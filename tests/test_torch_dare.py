"""Port parity: the DARE bank (``ops/dare.py``) and IHGP's steady-state tables
(``inference.ihgp.build_tables``), float64 on the CPU.

- ``dare_filter``, ``dare_residual`` and ``dlyap_doubling`` against
  ``nsgp_tpu.ops.dare`` at rtol 1e-10 over a batch of random stable systems
  (one batched call in the port, ``jax.vmap`` in JAX), and the unstable,
  undetectable scalar system whose doubling iterate diverges (the residual
  flags it in both).
- ``cubic_interp_matrix``: the same array as JAX's.
- ``build_tables`` on the SAME block SSM (assembled by JAX and handed to both,
  so only the bank is compared): every field within 1e-9 of its max |value|,
  for the toy model of ``tests/test_ihgp.py``, for ``grid_lo=-6`` with
  ``pf_correct=0.5``, and for the sabotaged channel of ``tests/test_dare.py``
  (all its grid points fail; the tables stay finite and the healthy channels
  equal the unsabotaged bank's).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsgp_tpu.inference import ihgp as jih
from nsgp_tpu.models.gtnmf import GTNMFModel as JModel
from nsgp_tpu.models.gtnmf import GTNMFParams as JParams
from nsgp_tpu.ops import dare as jdare
from nsgp_tpu_torch.inference import ihgp as tih
from nsgp_tpu_torch.ops import dare as tdare
from nsgp_tpu_torch.ops.ssm import BlockSSM
from torch_threads import one_torch_thread  # noqa: F401


def _stable_systems(n, bs, seed):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, bs, bs)) * 0.3
    rho = np.abs(np.linalg.eigvals(A)).max(-1)
    A = A / np.maximum(1.0, 1.1 * rho)[:, None, None]
    h = rng.normal(size=(n, bs))
    Lq = rng.normal(size=(n, bs, bs)) * 0.5
    Q = Lq @ Lq.transpose(0, 2, 1) + 0.01 * np.eye(bs)
    r = 10.0 ** rng.uniform(-2, 2, n)
    return A, h, Q, r


@jax.jit
def _jax_dare(A, h, Q, r, P_off, M):
    P = jax.vmap(jdare.dare_filter)(A, h, Q, r)
    return (P, jax.vmap(jdare.dare_residual)(P_off, A, h, Q, r),
            jax.vmap(jdare.dlyap_doubling)(M, Q))


@pytest.mark.parametrize("bs", [2, 4])
def test_dare_functions_match_jax(bs):
    A, h, Q, r = _stable_systems(6, bs, seed=bs)
    P_ref = tdare.dare_filter(*(torch.tensor(x) for x in (A, h, Q, r)))
    # the residual away from the fixed point, where it is more than rounding
    P_off = P_ref.numpy() * 1.01 + 0.01 * np.eye(bs)
    M = A * 0.9
    P_j, res_j, X_j = _jax_dare(*(jnp.asarray(x) for x in (A, h, Q, r, P_off, M)))
    np.testing.assert_allclose(P_ref.numpy(), np.asarray(P_j), rtol=1e-10, atol=1e-14)
    res0 = tdare.dare_residual(P_ref, *(torch.tensor(x) for x in (A, h, Q, r)))
    assert res0.shape == (6,) and float(res0.max()) < 1e-8
    res_t = tdare.dare_residual(torch.tensor(P_off), *(torch.tensor(x) for x in (A, h, Q, r)))
    assert float(res_t.min()) > 1e-4
    np.testing.assert_allclose(res_t.numpy(), np.asarray(res_j), rtol=1e-10)
    X_t = tdare.dlyap_doubling(torch.tensor(M), torch.tensor(Q))
    np.testing.assert_allclose(X_t.numpy(), np.asarray(X_j), rtol=1e-10, atol=1e-14)


def test_dare_flags_the_undetectable_unstable_system_as_jax():
    """A = 1.05, h = 0: no stabilizing solution; the iterate diverges and the
    residual is inf or large in both packages, with no exception raised."""
    A, h, Q = np.array([[1.05]]), np.array([0.0]), np.array([[1.0]])
    P_j = jdare.dare_filter(jnp.asarray(A), jnp.asarray(h), jnp.asarray(Q), jnp.asarray(1.0))
    P_t = tdare.dare_filter(torch.tensor(A), torch.tensor(h), torch.tensor(Q), 1.0)
    np.testing.assert_array_equal(np.isfinite(P_t.numpy()), np.isfinite(np.asarray(P_j)))
    res_j = float(jdare.dare_residual(P_j, jnp.asarray(A), jnp.asarray(h), jnp.asarray(Q),
                                      jnp.asarray(1.0)))
    res_t = tdare.dare_residual(P_t, torch.tensor(A), torch.tensor(h), torch.tensor(Q), 1.0).item()
    assert not np.isfinite(res_j) or res_j > 1.0
    assert not np.isfinite(res_t) or res_t > 1.0
    if np.isfinite(res_j):
        np.testing.assert_allclose(res_t, res_j, rtol=1e-10)


def test_cubic_interp_matrix_equals_jax():
    xg, xq = np.linspace(-2.0, 4.0, 32), np.linspace(-2.0, 4.0, 200)
    W = tdare.cubic_interp_matrix(xg, xq)
    assert W.dtype == np.float64 and W.shape == (200, 32)
    np.testing.assert_array_equal(W, jdare.cubic_interp_matrix(xg, xq))


@functools.lru_cache(maxsize=None)
def _ssms():
    """JAX block SSMs (one jitted assembly each): the toy of
    tests/test_ihgp.py (D=3, N=2, matern32/matern52), and the model of
    tests/test_dare.py:39-80 healthy and with channel 0 unstable and
    undetectable."""
    jm = JModel(D=3, N=2, kernel1="matern32", kernel2="matern52", p_cubature=7)
    jp = JParams(lik=jnp.asarray(0.05), sub_var=jnp.linspace(0.5, 1.5, 3),
                 sub_len=jnp.linspace(30.0, 90.0, 3), omega=jnp.linspace(0.2, 1.2, 3),
                 mod_var=jnp.full((2,), 1.5), mod_len=jnp.asarray([300.0, 500.0]),
                 W=jax.random.uniform(jax.random.PRNGKey(0), (3, 2), minval=0.2, maxval=1.0))
    toy = jax.jit(jm.build_ssm)(jp)
    jm = JModel(D=2, N=1, kernel1="matern32", kernel2="matern52")
    jp = JParams(lik=jnp.asarray(0.05), sub_var=jnp.asarray([1.0, 1.0]),
                 sub_len=jnp.asarray([40.0, 60.0]), omega=jnp.asarray([0.3, 1.0]),
                 mod_var=jnp.asarray([1.5]), mod_len=jnp.asarray([300.0]), W=jnp.ones((2, 1)))
    healthy = jax.jit(jm.build_ssm)(jp)
    bad = healthy._replace(A=healthy.A.at[0].set(1.05 * jnp.eye(healthy.block_size)),
                           H=healthy.H.at[0].set(0.0))
    return toy, healthy, bad


def _port_ssm(ssm):
    return BlockSSM(*[torch.tensor(np.asarray(x)) if hasattr(x, "shape") else x for x in ssm])


def _assert_tables(tb_t, tb_j):
    for f in jih.IHGPTables._fields:
        a, b = getattr(tb_t, f).numpy(), np.asarray(getattr(tb_j, f))
        assert a.shape == b.shape and np.all(np.isfinite(a)), f
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-9 * np.abs(b).max(), err_msg=f)


@pytest.mark.parametrize("case", ["toy", "grid_lo-6_pf_correct", "sabotaged"])
def test_build_tables_match_jax(case):
    kw = dict(grid_lo=-6.0, pf_correct=0.5) if case == "grid_lo-6_pf_correct" else {}
    toy, healthy, bad = _ssms()
    ssm_j = bad if case == "sabotaged" else toy
    tb_t = tih.build_tables(_port_ssm(ssm_j), tih.IHGPConfig(**kw))
    tb_j = jax.jit(jih.build_tables, static_argnums=1)(ssm_j, jih.IHGPConfig(**kw))
    _assert_tables(tb_t, tb_j)
    if case == "sabotaged":
        healthy = tih.build_tables(_port_ssm(healthy), tih.IHGPConfig())
        for f in ("Ph", "Gn", "hPph", "hPSh"):
            np.testing.assert_allclose(getattr(tb_t, f)[1:].numpy(),
                                       getattr(healthy, f)[1:].numpy(), rtol=1e-9, err_msg=f)
    # the forward tables alone (the energy's) are the same tensors' values
    fwd = tih.build_tables(_port_ssm(ssm_j), tih.IHGPConfig(**kw), smoother=False)
    assert fwd.Gn is None and fwd.hPSh is None
    for f in ("log_r", "Ph", "hPph"):
        assert torch.equal(getattr(fwd, f), getattr(tb_t, f)), f
