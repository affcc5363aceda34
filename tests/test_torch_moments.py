"""Port parity: EP moment matching (``ops/moments.py``), float64.

Cavities, observations and weights are made with numpy and fed to both
packages.  Tolerance 1e-10 relative: the same float64 arithmetic with
sums taken in another order, amplified by the 1/Z and squared-derivative
terms.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsgp_tpu.ops import moments as jm
from nsgp_tpu_torch.ops import moments as tm
from torch_threads import one_torch_thread  # noqa: F401

RTOL, ATOL = 1e-10, 1e-12
D, N = 3, 2


def _inputs(T, seed):
    rng = np.random.default_rng(seed)
    mu = np.concatenate([rng.normal(0, 1, (T, D)), rng.normal(0.5, 1, (T, N))], 1)
    s2 = np.concatenate([rng.uniform(0.1, 2, (T, D)), rng.uniform(0.05, 1, (T, N))], 1)
    y = rng.normal(0, 2, T)
    W = rng.uniform(0.2, 1.0, (D, N))
    return y, mu, s2, W


def _both(fn_j, fn_t, mp_kw, sn2, y, mu, s2, W, **kw):
    mp_j = jm.MomentParams(D=D, N=N, **mp_kw)
    mp_t = tm.MomentParams(D=D, N=N, **mp_kw)
    out_j = fn_j(mp_j, jnp.asarray(sn2), *map(jnp.asarray, (y, mu, s2, W)), **kw)
    out_t = fn_t(mp_t, torch.tensor(sn2, dtype=torch.float64),
                 *map(torch.tensor, (y, mu, s2, W)), **kw)
    return out_j, out_t


def _assert_close(out_t, out_j):
    for a, b in zip(out_t, out_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("variant", ["amp", "sq"])
@pytest.mark.parametrize("link", ["softplus", "exp"])
def test_moments_match(variant, link):
    y, mu, s2, W = _inputs(64, seed=0)
    out_j, out_t = _both(jm.moments, tm.moments, dict(link=link, variant=variant),
                         0.05, y, mu, s2, W, ep_fraction=0.5)
    _assert_close(out_t, out_j)


@pytest.mark.parametrize("p,use_pep", [(7, True), (5, False)])
def test_moments_rules_and_pep_const_match(p, use_pep):
    """ut7 (negative weights) with the Power-EP constant, and ut5."""
    y, mu, s2, W = _inputs(32, seed=1)
    out_j, out_t = _both(jm.moments, tm.moments, dict(p_cubature=p, use_pep_const=use_pep),
                         0.1, y, mu, s2, W, ep_fraction=0.5)
    _assert_close(out_t, out_j)


def test_moments_chunked_match():
    """Chunked all-T re-site (T not a multiple of the chunk)."""
    y, mu, s2, W = _inputs(100, seed=2)
    out_j, out_t = _both(jm.moments_chunked, tm.moments_chunked, dict(variant="sq"),
                         0.05, y, mu, s2, W, ep_fraction=0.5, chunk=16)
    _assert_close(out_t, out_j)
    full = tm.moments(tm.MomentParams(D=D, N=N, variant="sq"),
                      torch.tensor(0.05, dtype=torch.float64),
                      *map(torch.tensor, (y, mu, s2, W)), 0.5)
    for a, b in zip(out_t, full):  # chunking changes only the batch of each op
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-14)


def test_outlier_hits_raw_z_floor():
    """A 50-sigma observation drives the raw Z under 1e-10: lZ sits on the
    floor and the floored Z divides the derivatives (gentle rejection)."""
    y, mu, s2, W = _inputs(8, seed=3)
    y[3] = 50.0 * np.abs(y).max() + 50.0
    out_j, out_t = _both(jm.moments, tm.moments, dict(), 1e-3, y, mu, s2, W)
    _assert_close(out_t, out_j)
    lZ = out_t[0]
    assert lZ[3].item() == pytest.approx(np.log(1e-10), rel=1e-12)
    assert bool(torch.isfinite(out_t[1]).all() and torch.isfinite(out_t[2]).all())
