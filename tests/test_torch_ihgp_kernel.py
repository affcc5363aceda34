"""Port parity: IHGP's two sequential passes, whose plain twins are the CPU
path of K5 and K6 (``ops/fused_ihgp.py``), against the JAX scans they stand
for, ``_steady_filter_seq`` and ``_steady_smoother(parallel=False)``
(``nsgp_tpu/inference/ihgp.py``); float64 on the CPU.

The toy model of ``tests/test_torch_ihgp.py`` (D=3, N=2, matern32 subbands,
matern52 modulators padded into bs=4 blocks), T = 60; the same numpy inputs
go through both packages, every output at rtol 1e-10 (relative to its max
|value|), grid indices equal:

- the ADF sweep (zero sites, every step matched) over a NaN gap;
- a later pass of the sequential form: the last step matched, fixed sites
  elsewhere, non-zero on the unobserved steps (their next table row comes
  from tt, their index from tt_eff = 0), exactly 0 on a third of the steps
  (the pure-prediction branch);
- the first step takes the Pinf row (its mean against the formula);
- the smoother on the ADF sweep's filtered means.

The port runs through the engine's own entry (``_steady_filter_seq``,
``_steady_smoother``), which on CPU tensors calls the twins.  Each JAX pass
compiles once (``jax.jit`` over the arrays, ``unroll=1``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsgp_tpu.inference import ihgp as jih
from nsgp_tpu.models.gtnmf import GTNMFModel as JModel
from nsgp_tpu.models.gtnmf import GTNMFParams as JParams
from nsgp_tpu.ops.kalman import Sites as JSites
from nsgp_tpu.ops.moments import moments as jmoments
from nsgp_tpu_torch.convert import params_from_numpy
from nsgp_tpu_torch.inference import ihgp as tih
from nsgp_tpu_torch.models.gtnmf import GTNMFModel
from nsgp_tpu_torch.ops import fused_ihgp as fih
from nsgp_tpu_torch.ops.kalman import Sites
from torch_threads import one_torch_thread  # noqa: F401

T = 60
DAMP = 0.1
RTOL = 1e-10


@pytest.fixture(scope="module")
def toy():
    jm = JModel(D=3, N=2, kernel1="matern32", kernel2="matern52", p_cubature=7)
    jp = JParams(lik=jnp.asarray(0.05), sub_var=jnp.linspace(0.5, 1.5, 3),
                 sub_len=jnp.linspace(30.0, 90.0, 3), omega=jnp.linspace(0.2, 1.2, 3),
                 mod_var=jnp.full((2,), 1.5), mod_len=jnp.asarray([300.0, 500.0]),
                 W=jax.random.uniform(jax.random.PRNGKey(0), (3, 2), minval=0.2, maxval=1.0))
    cfg = jih.IHGPConfig(unroll=1)
    ssm_j = jax.jit(jm.build_ssm)(jp)
    tables_j = jax.jit(lambda s: jih.build_tables(s, cfg))(ssm_j)
    mp_j = jm.moment_params()
    mom = lambda y_k, fmu, fs2, frac: jmoments(mp_j, jp.lik, y_k, fmu, fs2, jp.W, frac)
    jfilter = jax.jit(lambda y, mask, tt, tn, match: jih._steady_filter_seq(
        ssm_j, tables_j, y, mask, JSites(tt, tn), mom, DAMP, match, unroll=1))
    jsmooth = jax.jit(lambda ms, idx: jih._steady_smoother(ssm_j, tables_j, ms, idx,
                                                           parallel=False, unroll=1))
    model = GTNMFModel(*jm)
    params = params_from_numpy({k: np.asarray(v) for k, v in jp._asdict().items()},
                               device="cpu", dtype=torch.float64)
    ssm_t = model.build_ssm(params)
    tables_t = tih.build_tables(ssm_t, tih.IHGPConfig())

    def tfilter(y, mask, tt, tn, match):
        t = lambda x: torch.tensor(np.asarray(x))
        return tih._steady_filter_seq(ssm_t, tables_t, t(y), t(mask), Sites(t(tt), t(tn)),
                                      model.moment_params(), params.W, params.lik, DAMP, t(match))

    tsmooth = lambda ms, idx: tih._steady_smoother(ssm_t, tables_t, ms, idx, parallel=False)
    return dict(jfilter=jfilter, jsmooth=jsmooth, tfilter=tfilter, tsmooth=tsmooth, ssm_t=ssm_t)


def _inputs(case):
    """(y, mask, ttau, tnu, match) as numpy, the same for both packages."""
    rng = np.random.default_rng(7)
    t = np.arange(T)
    y = sum((0.4 + 0.3 * np.sin(0.05 * t + k)) * np.cos(om * t + k)
            for k, om in enumerate((0.2, 0.7, 1.2))) + 0.2 * rng.normal(size=T)
    y[20:28] = np.nan
    mask = ~np.isnan(y)
    y = np.nan_to_num(y)
    C = 5
    if case == "adf":
        tt = tn = np.zeros((T, C))
        match = np.ones(T, bool)
    else:  # a later pass: non-zero fixed sites, a third of them exactly 0
        tt = rng.uniform(0.0, 40.0, (T, C)) * (rng.uniform(size=(T, C)) > 0.33)
        tn = rng.normal(size=(T, C)) * tt
        match = np.zeros(T, bool)
        match[-1] = True
    return y, mask, tt, tn, match


def _close(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, what
    np.testing.assert_allclose(a, b, rtol=RTOL, atol=RTOL * np.abs(b).max(), err_msg=what)


@pytest.fixture(scope="module")
def runs(toy):
    out = {}
    for case in ("adf", "later"):
        args = _inputs(case)
        out[case] = (args, toy["jfilter"](*map(jnp.asarray, args)), toy["tfilter"](*args))
    return out


@pytest.mark.parametrize("case", ["adf", "later"])
def test_steady_sweep_twin_matches_jax(runs, case):
    (y, mask, tt, tn, match), (ms_j, idx_j, lZ_j, s_j), (ms_t, idx_t, lZ_t, s_t) = runs[case]
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    assert len(np.unique(np.asarray(idx_j))) > 3
    for what, a, b in (("ms", ms_t, ms_j), ("lZ", lZ_t, lZ_j), ("ttau", s_t.ttau, s_j.ttau),
                       ("tnu", s_t.tnu, s_j.tnu)):
        _close(a.numpy(), b, what)
    gap = ~mask
    G = 200
    if case == "adf":  # unobserved: lZ = 0 and zero sites, the top of the grid
        assert np.all(lZ_t.numpy()[gap] == 0.0) and np.all(idx_t.numpy()[gap] == G - 1)
    else:
        # the fixed sites pass through untouched but the last
        np.testing.assert_array_equal(s_t.ttau.numpy()[:-1], tt[:-1])
        np.testing.assert_array_equal(s_t.tnu.numpy()[:-1], tn[:-1])
        # the index of an unobserved step is the top of the grid (tt_eff = 0),
        # while the next step's row came from its non-zero tt: the mean moves
        assert np.all(idx_t.numpy()[gap] == G - 1)
        assert np.any(tt[gap] > 0.0)
        # a zero site predicts purely: no gain, m_k = A m_{k-1}
        assert np.all(lZ_t.numpy()[:-1] == 0.0)


def test_first_step_takes_the_pinf_row(toy, runs):
    """m_0 = Pinf h (tn_0 - tt_0 fmu_0) / (tt_0 h'Pinf h + 1) with fmu_0 = 0:
    the first step's predictive covariance is Pinf, not a table row."""
    ssm = toy["ssm_t"]
    _, _, (ms_t, _, _, s_t) = runs["adf"]
    Pinfh = (ssm.Pinf @ ssm.H[..., None])[..., 0]  # (C, bs)
    hPinfh = (ssm.H * Pinfh).sum(-1)
    tt0, tn0 = s_t.ttau[0], s_t.tnu[0]
    assert bool((tt0 > 0).all())
    m0 = Pinfh * (tn0 / (tt0 * hPinfh + 1.0))[:, None]
    _close(ms_t[0].numpy(), m0.reshape(-1).numpy(), "m_0")


def test_steady_smoother_twin_matches_jax(toy, runs):
    _, (ms_j, idx_j, _, _), (ms_t, idx_t, _, _) = runs["adf"]
    sm_j = toy["jsmooth"](ms_j, idx_j)
    sm_t = toy["tsmooth"](ms_t, idx_t)
    _close(sm_t.numpy(), sm_j, "smoothed means")
    np.testing.assert_array_equal(sm_t[-1].numpy(), ms_t[-1].numpy())
    # the wrapper on CPU tensors is the twin
    assert torch.equal(sm_t, fih.fused_ihgp_smooth_plain(ms_t, idx_t, toy["ssm_t"].A,
                                                         tih.build_tables(
                                                             toy["ssm_t"], tih.IHGPConfig()).Gn))


def test_lookup_matches_jax_at_the_grid_edges():
    """The grid lookup K5 repeats in its own arithmetic: ttau 1e-12 on
    either side of every midpoint between grid points (an index off by one
    anywhere fails), 0, negative, NaN, tiny and huge.  The midpoints
    themselves sit within an ulp of an index boundary, where XLA's log10 and
    torch's differ by that ulp (12 of 199 flip on this machine)."""
    log_r = np.linspace(-2.0, 4.0, 200)
    step = log_r[1] - log_r[0]
    mids = 10.0 ** -(log_r[:-1] + np.log10((1.0 + 10.0**step) / 2.0))  # ttau = 1/r at midpoints
    tt = np.concatenate([mids * (1 + 1e-12), mids * (1 - 1e-12),
                         [0.0, -1.0, np.nan, 1e-300, 1e300, 1e-2, 1e2]])
    tb = jih.IHGPTables(log_r=jnp.asarray(log_r), Ph=None, Gn=None, hPph=None, hPSh=None)
    idx_j = np.asarray(jih._lookup_idx(tb, jnp.asarray(tt)))
    idx_t = fih.lookup_idx(fih.lookup_consts(torch.tensor(log_r)), torch.tensor(tt))
    np.testing.assert_array_equal(idx_t.numpy(), idx_j)
    assert idx_j.min() == 0 and idx_j.max() == 199
    n = len(mids)  # the two sides of a midpoint are neighbouring indices
    np.testing.assert_array_equal(idx_j[:n] + 1, idx_j[n:2 * n])  # a larger ttau: a lower index
