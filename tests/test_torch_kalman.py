"""Port parity: the fused passes' plain versions vs the Pallas kernels run in
interpret mode, and the sequential engine vs ``nsgp_tpu/ops/kalman.py``.

Small shapes (D=3, N=2, T <= 96, Pallas block 32), float64.  Both matern52
(3 states) and matern32 (2 states) modulators sit in bs=4 blocks, so every
case carries padded state dims.  Tolerances: rtol 1e-7 / atol 1e-9 against
the Pallas kernels (the bar of tests/test_pallas_kalman.py); rtol 1e-9 /
atol 1e-11 against the sequential scans (same arithmetic in another
summation order, amplified by the smoother gains' solve against Pp, which
is ill-conditioned for the slow modulators: 1.4e-10 measured).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsgp_tpu.models.gtnmf import GTNMFModel as JModel
from nsgp_tpu.models.gtnmf import GTNMFParams as JParams
from nsgp_tpu.models.gtnmf import sample_prior as j_sample_prior
from nsgp_tpu.ops import kalman as jk
from nsgp_tpu.ops import moments as jmom
from nsgp_tpu.ops import pallas_kalman as pk
from nsgp_tpu_torch.convert import params_from_numpy
from nsgp_tpu_torch.models.gtnmf import GTNMFModel
from nsgp_tpu_torch.ops import fused_kalman as fk
from nsgp_tpu_torch.ops import kalman as tk
from nsgp_tpu_torch.ops import moments as tmom
from torch_threads import one_torch_thread  # noqa: F401

D, N, T, BLOCK = 3, 2, 96, 32
PALLAS = dict(rtol=1e-7, atol=1e-9)
SEQ = dict(rtol=1e-9, atol=1e-11)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(a, b, tol):
    np.testing.assert_allclose(_np(a), _np(b), **tol)


def toy(kernel2):
    """Both packages' model, params and block SSM on identical numbers."""
    rng = np.random.default_rng(0)
    p = dict(lik=np.asarray(0.05), sub_var=np.linspace(0.5, 1.5, D),
             sub_len=np.linspace(20.0, 80.0, D), omega=np.linspace(0.1, 1.0, D),
             mod_var=np.full(N, 1.5), mod_len=np.linspace(300.0, 600.0, N),
             W=rng.uniform(0.2, 1.0, (D, N)))
    jm = JModel(D=D, N=N, kernel1="matern32", kernel2=kernel2)
    jp = JParams(**{k: jnp.asarray(v) for k, v in p.items()})
    tm = GTNMFModel(*jm)
    tp = params_from_numpy(p, device="cpu", dtype=torch.float64)
    return jm, jp, jm.build_ssm(jp), tm, tp, tm.build_ssm(tp)


def random_sites(seed, T=T, C=D + N):
    rng = np.random.default_rng(seed)
    ttau = rng.uniform(0.0, 5.0, (T, C)) * (rng.uniform(size=(T, C)) > 0.2)
    return ttau, rng.normal(size=(T, C)) * ttau


def observations(jm, jp, seed):
    """A prior sample with a NaN gap and one 50-sigma outlier."""
    y, _, _ = j_sample_prior(jax.random.PRNGKey(seed), jm, jp, T=T)
    y = np.array(y)
    y[30:40] = np.nan
    y[70] = 50.0 * np.nanstd(y)
    return y


def bmajor_to_cmajor(ms_b, Ps_b, C, bs):
    """The Pallas kernels' padded (Tp*bs, C) rows -> (T, C, bs[, bs])."""
    ms = np.asarray(ms_b)[: T * bs].reshape(T, bs, C).transpose(0, 2, 1)
    Ps = np.asarray(Ps_b)[: T * bs * bs].reshape(T, bs, bs, C).transpose(0, 3, 1, 2)
    return ms, Ps


@pytest.mark.parametrize("kernel2", ["matern52", "matern32"])
def test_fwd_bwd_plain_match_pallas_interpret(kernel2):
    """K1 + K2 plain versions == filter_smoother_pallas(interpret=True)."""
    _, _, jssm, _, _, tssm = toy(kernel2)
    tt, tn = random_sites(1)
    sm_j, sP_j = pk.filter_smoother_pallas(jssm, jk.Sites(jnp.asarray(tt), jnp.asarray(tn)),
                                           BLOCK, True)
    sm_t, sP_t = fk.filter_smoother_fused(tssm, tk.Sites(torch.tensor(tt), torch.tensor(tn)))
    assert sm_t.shape == sm_j.shape and sP_t.shape == sP_j.shape
    _close(sm_t, sm_j, PALLAS)
    _close(sP_t, sP_j, PALLAS)


@pytest.mark.parametrize("kernel2", ["matern52", "matern32"])
def test_adf_plain_matches_pallas_interpret(kernel2):
    """K3 plain version == adf_filter_pallas(interpret=True): filtered
    trajectory, lZ and sites, across a NaN gap and a Z-floor outlier; then
    K2 on that trajectory == smoother_pallas_bmajor."""
    jm, jp, jssm, tm, tp, tssm = toy(kernel2)
    y = observations(jm, jp, seed=5)
    mask = ~np.isnan(y)
    ms_b, Ps_b, lZ_j, sites_j = pk.adf_filter_pallas(
        jm.moment_params(), jssm, jp.W, jp.lik, jnp.asarray(y), jnp.asarray(mask), 0.5,
        BLOCK, True)
    sm_j, sP_j = pk.smoother_pallas_bmajor(jssm, ms_b, Ps_b, T, BLOCK, True)
    ms_t, Ps_t, lZ_t, sites_t = fk.adf_filter_fused(
        tm.moment_params(), tssm, tp.W, tp.lik, torch.tensor(y), torch.tensor(mask), 0.5)
    ms_j, Ps_j = bmajor_to_cmajor(ms_b, Ps_b, D + N, 4)
    for a, b in [(ms_t, ms_j), (Ps_t, Ps_j), (lZ_t, lZ_j), (sites_t.ttau, sites_j.ttau),
                 (sites_t.tnu, sites_j.tnu)]:
        _close(a, b, PALLAS)
    assert lZ_t[35].item() == 0.0 and float(sites_t.ttau[35].abs().max()) == 0.0
    sm_t, sP_t = fk.smoother_fused(tssm, ms_t, Ps_t)
    _close(sm_t, sm_j, PALLAS)
    _close(sP_t, sP_j, PALLAS)


def test_sequential_engine_matches_jax():
    """ops/kalman.py: fixed-site filter, RTS smoother, chunked gains,
    observable marginals, and the ADF filter with last-step matching."""
    jm, jp, jssm, tm, tp, tssm = toy("matern52")
    tt, tn = random_sites(2, T=64)
    js = jk.Sites(jnp.asarray(tt), jnp.asarray(tn))
    ts = tk.Sites(torch.tensor(tt), torch.tensor(tn))
    fr_j = jk.filter_with_sites(jssm, js)
    fr_t = tk.filter_with_sites(tssm, ts)
    _close(fr_t.ms, fr_j.ms, SEQ)
    _close(fr_t.Ps, fr_j.Ps, SEQ)
    for a, b in zip(tk.smoother_gains_chunked(tssm, fr_t.Ps, chunk=24),
                    jk.smoother_gains_chunked(jssm, fr_j.Ps, chunk=24)):
        _close(a, b, SEQ)
    sm_t, sP_t = tk.rts_smoother(tssm, fr_t)
    sm_j, sP_j = jk.rts_smoother(jssm, fr_j)
    _close(sm_t, sm_j, SEQ)
    _close(sP_t, sP_j, SEQ)
    for a, b in zip(tk.observable_marginals(tssm, sm_t, sP_t),
                    jk.observable_marginals(jssm, sm_j, sP_j)):
        _close(a, b, SEQ)

    y = observations(jm, jp, seed=6)[:64]
    mask = ~np.isnan(y)
    last = np.zeros(64, bool)
    last[-1] = True
    mp_j, mp_t = jm.moment_params(), tm.moment_params()

    def mom_j(y_k, fmu, fs2, frac):
        return jmom.moments(mp_j, jp.lik, y_k, fmu, fs2, jp.W, frac)

    def mom_t(y_k, fmu, fs2, frac):
        return tmom.moments(mp_t, tp.lik, y_k, fmu, fs2, tp.W, frac)

    for match in (None, last):
        out_j = jk.adf_filter(jssm, jnp.asarray(np.nan_to_num(y)), jnp.asarray(mask), js,
                              mom_j, 0.5, None if match is None else jnp.asarray(match))
        out_t = tk.adf_filter(tssm, torch.tensor(np.nan_to_num(y)), torch.tensor(mask), ts,
                              mom_t, 0.5, None if match is None else torch.tensor(match))
        (trj, lZj, sj), (trt, lZt, st) = out_j, out_t
        for a, b in [(trt.ms, trj.ms), (trt.Ps, trj.Ps), (lZt, lZj), (st.ttau, sj.ttau),
                     (st.tnu, sj.tnu)]:
            _close(a, b, SEQ)


def test_wrappers_dispatch_on_device():
    """CPU tensors run the plain versions without touching the launch
    counters; tensors on other devices, or on two devices, raise."""
    _, _, _, _, _, tssm = toy("matern52")
    tt, tn = (torch.tensor(x) for x in random_sites(3, T=8))
    fk.reset_launches()
    ms, Ps = fk.fused_fwd(tt, tn, tssm.A, tssm.Q, tssm.Pinf, tssm.H)
    assert ms.shape == (8, D + N, 4) and Ps.shape == (8, D + N, 4, 4)
    assert all(fn.launches == 0 for fn in fk.WRAPPERS)
    ref = fk.fused_fwd_plain(tt, tn, tssm.A, tssm.Q, tssm.Pinf, tssm.H)
    assert torch.equal(ms, ref[0]) and torch.equal(Ps, ref[1])
    meta = [x.to("meta") for x in (tt, tn, tssm.A, tssm.Q, tssm.Pinf, tssm.H)]
    with pytest.raises(ValueError, match="not meta"):
        fk.fused_fwd(*meta)
    with pytest.raises(ValueError, match="one device"):
        fk.fused_bwd(ms, Ps.to("meta"), tssm.A, tssm.Q, tssm.H)
