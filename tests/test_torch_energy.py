"""Port parity: ``ep_energy`` and its autograd gradient, float64 on the CPU.

The same numpy inputs (a JAX ``sample_prior`` draw) go through JAX
``ep_energy`` under ``jax.value_and_grad`` and the port's ``ep_energy``
under ``torch.autograd.grad``: the value at rtol 1e-10, the gradient of
every ``GTNMFParams`` leaf at rtol 1e-7.  Cases cover 'amp' and 'sq', the
softplus and exp links, one and three EP sweeps, a NaN gap, and a 50-sigma
outlier that drives the raw Z under its floor (with ut7's negative weights,
where the shifted sum can fall to the clamp).  JAX runs with ``unroll=1``:
the same values, a quarter of the compile.

Also the two repairs of ``ops/moments.py``: the max shift carries no
gradient (as JAX's ``stop_gradient``), and the sigma points are built once
per rule, dtype and device with the same bits as built on every call.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsgp_tpu.inference import ep as jep
from nsgp_tpu.models.gtnmf import GTNMFModel as JModel
from nsgp_tpu.models.gtnmf import GTNMFParams as JParams
from nsgp_tpu.models.gtnmf import sample_prior as j_sample_prior
from nsgp_tpu_torch.convert import params_from_numpy
from nsgp_tpu_torch.inference import ep as tep
from nsgp_tpu_torch.models.gtnmf import PARAM_NAMES, GTNMFModel, GTNMFParams
from nsgp_tpu_torch.ops import cubature
from nsgp_tpu_torch.ops import moments as tm
from torch_threads import one_torch_thread  # noqa: F401

T = 96
D, N = 3, 2


def _toy(variant, link, p_cubature=9):
    rng = np.random.default_rng(0)
    jm = JModel(D=D, N=N, kernel1="matern32", kernel2="matern52", link=link, variant=variant,
                p_cubature=p_cubature)
    jp = JParams(lik=jnp.asarray(0.05), sub_var=jnp.linspace(0.5, 1.5, D),
                 sub_len=jnp.linspace(20.0, 80.0, D), omega=jnp.linspace(0.1, 1.0, D),
                 mod_var=jnp.full((N,), 1.5), mod_len=jnp.linspace(300.0, 600.0, N),
                 W=jnp.asarray(rng.uniform(0.2, 1.0, (D, N))))
    return jm, jp


def _signal(jm, jp, case):
    y, _, _ = j_sample_prior(jax.random.PRNGKey(5), jm, jp, T=T)
    y = np.array(y)
    if case == "gap":
        y[40:55] = np.nan
    elif case == "outlier":  # Z under its floor (the speech6 onsets)
        y[60] = 50.0 * np.nanstd(y)
    return y


def _leaves(jp):
    params = params_from_numpy({k: np.asarray(v) for k, v in jp._asdict().items()},
                               device="cpu", dtype=torch.float64)
    return {k: getattr(params, k).clone().requires_grad_(True) for k in PARAM_NAMES}


def _port_value_and_grad(jm, jp, y, cfg, mask=None):
    leaves = _leaves(jp)
    e = tep.ep_energy(GTNMFModel(*jm), GTNMFParams(**leaves), torch.tensor(y), mask, cfg,
                      device="cpu")
    return e, dict(zip(PARAM_NAMES, torch.autograd.grad(e, list(leaves.values()))))


# (variant, link, ep_itts, signal, p_cubature): every variant, link and sweep
# count, with and without a gap (one JAX compile each, 4 s for one sweep and
# 11 s for three; the outlier at ut9 reuses the first case's)
CASES = [
    ("amp", "softplus", 1, "clean", 9),
    ("amp", "softplus", 1, "outlier", 9),
    ("amp", "exp", 1, "gap", 9),
    ("sq", "softplus", 1, "clean", 9),
    ("sq", "exp", 3, "gap", 9),
    ("sq", "softplus", 1, "outlier", 7),
]


@pytest.mark.parametrize("variant,link,itts,case,p_cub", CASES)
def test_ep_energy_and_gradient_match_jax(variant, link, itts, case, p_cub):
    jm, jp = _toy(variant, link, p_cub)
    y = _signal(jm, jp, case)
    e_j, g_j = jax.value_and_grad(
        lambda p: jep.ep_energy(jm, p, jnp.asarray(y), None,
                                jep.EPConfig(ep_itts=itts, unroll=1)))(jp)
    e_t, g_t = _port_value_and_grad(jm, jp, y, tep.EPConfig(ep_itts=itts))
    assert e_t.shape == () and e_t.dtype == torch.float64
    np.testing.assert_allclose(e_t.item(), float(e_j), rtol=1e-10)
    for k in PARAM_NAMES:
        ref = np.asarray(getattr(g_j, k))
        assert np.all(np.isfinite(ref)) and np.abs(ref).max() > 0, k
        np.testing.assert_allclose(g_t[k].numpy(), ref, rtol=1e-7,
                                   atol=1e-12 * np.abs(ref).max(), err_msg=k)


def test_outlier_hits_the_z_floor():
    """The outlier case is the one it claims to be: at the outlier step the
    raw log Z lies under log(z_floor), so lZ there is the floor."""
    jm, jp = _toy("amp", "softplus")
    y = _signal(jm, jp, "outlier")
    model = GTNMFModel(*jm)
    params = GTNMFParams(**_leaves(jp))
    r = tep.ep_infer(model, params, torch.tensor(y), None, tep.EPConfig(ep_itts=1), device="cpu")
    np.testing.assert_allclose(r.lZ[60].item(), np.log(model.z_floor), rtol=1e-12)


def test_ep_energy_ignores_backend_and_follows_mask():
    """Energy mode is the sequential engine whatever the backend or jitter;
    an explicit mask equals the NaNs it stands for."""
    jm, jp = _toy("amp", "softplus")
    y = _signal(jm, jp, "gap")
    model = GTNMFModel(*jm)
    params = GTNMFParams(**_leaves(jp))
    seq = tep.ep_energy(model, params, torch.tensor(y), None, tep.EPConfig(ep_itts=3),
                        device="cpu")
    fused = tep.ep_energy(model, params, torch.tensor(y), None,
                          tep.EPConfig(ep_itts=3, backend="fused"), device="cpu")
    masked = tep.ep_energy(model, params, torch.tensor(np.nan_to_num(y)),
                           torch.tensor(~np.isnan(y)), tep.EPConfig(ep_itts=3), device="cpu")
    # jitter is ignored by the energy, as by JAX's (which never reads it there)
    jit = tep.ep_energy(model, params, torch.tensor(y), None,
                        tep.EPConfig(ep_itts=3, jitter=1e-6), device="cpu")
    assert seq.item() == fused.item() == masked.item() == jit.item()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tep.ep_energy(model, params, torch.tensor(y))


def _moment_inputs(T_, seed, C=D + N):
    rng = np.random.default_rng(seed)
    mu = torch.tensor(np.concatenate([rng.normal(0, 1, (T_, D)), rng.normal(0.5, 1, (T_, N))], 1))
    s2 = torch.tensor(np.concatenate([rng.uniform(0.1, 2, (T_, D)),
                                      rng.uniform(0.05, 1, (T_, N))], 1))
    y = torch.tensor(rng.normal(0, 2, T_))
    W = torch.tensor(rng.uniform(0.2, 1.0, (D, N)))
    return y, mu, s2, W


@pytest.mark.parametrize("p_cub", [7, 9])
def test_hoisted_sigma_points_keep_the_bits(p_cub, monkeypatch):
    """``moments`` with the shared sigma points gives the same bits as with
    points built afresh on every call (the construction before the hoist),
    batched and one site at a time; and the points are built once."""
    mp = tm.MomentParams(D=D, N=N, p_cubature=p_cub, variant="sq")
    y, mu, s2, W = _moment_inputs(16, 3)
    sn2 = torch.tensor(0.05, dtype=torch.float64)
    cached = [tm.moments(mp, sn2, y, mu, s2, W, 0.75), tm.moments(mp, sn2, y[3], mu[3], s2[3], W)]
    assert tm.sigma_points(mp) is tm.sigma_points(mp, torch.float64, "cpu")

    def fresh(mp_, dtype=torch.float64, device=None):
        w, x = cubature.unit_sigma_points(mp_.p_cubature, mp_.N, mp_.method)
        return (torch.as_tensor(w, dtype=dtype, device=device),
                torch.as_tensor(x.T, dtype=dtype, device=device))

    monkeypatch.setattr(tm, "sigma_points", fresh)
    rebuilt = [tm.moments(mp, sn2, y, mu, s2, W, 0.75), tm.moments(mp, sn2, y[3], mu[3], s2[3], W)]
    for a, b in zip(cached, rebuilt):
        for x, z in zip(a, b):
            assert torch.equal(x, z)


def test_max_shift_carries_no_gradient(monkeypatch):
    """Where the shifted sum is clamped to ``tiny`` and the floor is not
    active, a gradient through the shift would add d lmax; JAX stops it.  A
    floor of 0 (never active) and one sigma point's weight against another's
    at equal points make the shifted sum exactly zero."""
    mp = tm.MomentParams(D=1, N=1, p_cubature=3, z_floor=0.0)
    wn = torch.tensor([1.0, -1.0], dtype=torch.float64)
    xi = torch.zeros((2, 1), dtype=torch.float64)
    mu = torch.tensor([0.3, 0.2], dtype=torch.float64, requires_grad=True)
    s2 = torch.tensor([0.5, 0.4], dtype=torch.float64)
    W = torch.ones((1, 1), dtype=torch.float64)
    monkeypatch.setattr(tm, "sigma_points", lambda *a, **k: (wn, xi))
    lZ, _, _ = tm.moments(mp, torch.tensor(0.1, dtype=torch.float64),
                          torch.tensor(0.7, dtype=torch.float64), mu, s2, W)
    (g,) = torch.autograd.grad(lZ, mu)
    assert torch.equal(g, torch.zeros_like(g))
