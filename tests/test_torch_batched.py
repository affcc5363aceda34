"""Port parity: the batched ADF pass (K4's plain version) and ``ep_infer_batch``,
float64 on the CPU.

- ``fused_adf_mb_plain`` against ``adf_filter_pallas_mb(..., interpret=True)``
  chunk for chunk (``s_chunk`` 0 and 7: 7 forces a ragged last chunk), both
  links and variants, per-file masks, one file with an outlier that trips
  the raw-scale Z floor: rtol 1e-7 on trajectories and sites, 1e-9 on lZ.
- At BF = 1, ``s_chunk`` = 0 it equals ``fused_adf_plain`` to 1e-12.
- ``ep_infer_batch(backend="fused")`` against JAX ``backend="pallas"`` (atol
  1e-9 on Eft/Varft, rtol 1e-9 on nlZ) and against the port's own single-file
  ``ep_infer``; ``s_chunk`` 0 vs 7 to 1e-11; ``backend="seq"`` against the JAX
  vmap branch to 1e-10.
- The stationary-start guard of the pass-level fused entry points.
"""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsgp_tpu.inference import batched as jbt
from nsgp_tpu.inference import ep as jep
from nsgp_tpu.models.gtnmf import GTNMFModel as JModel
from nsgp_tpu.models.gtnmf import GTNMFParams as JParams
from nsgp_tpu.models.gtnmf import sample_prior as j_sample_prior
from nsgp_tpu.ops import pallas_kalman as jpk
from nsgp_tpu_torch import convert
from nsgp_tpu_torch.inference import batched as tbt
from nsgp_tpu_torch.inference import ep as tep
from nsgp_tpu_torch.inference import ihgp as tih
from nsgp_tpu_torch.models.gtnmf import GTNMFModel, stack_params
from nsgp_tpu_torch.ops import fused_kalman as fk
from nsgp_tpu_torch.ops import ssm as tssm
from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF, D, N, T = 3, 4, 2, 128
BLOCK = 64


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _toy_files():
    """Three files of one structure with different hyperparameters, masks
    that differ per file, and an outlier in file 1 that drives the raw Z
    under its floor.  Signals come from the JAX prior, as numpy."""
    jm = JModel(D=D, N=N, kernel1="exp", kernel2="matern52", p_cubature=7)
    plist, ys, masks = [], [], []
    for b in range(BF):
        rng = np.random.default_rng(17 * b)
        jp = JParams(
            lik=jnp.asarray(0.05 + 0.01 * b),
            sub_var=jnp.linspace(0.5, 1.5 + 0.2 * b, D),
            sub_len=jnp.linspace(30.0, 90.0 + 5 * b, D),
            omega=jnp.linspace(0.2, 1.2, D) * (1.0 + 0.03 * b),
            mod_var=jnp.full((N,), 1.5 + 0.1 * b),
            mod_len=jnp.linspace(200.0, 400.0, N),
            W=jnp.asarray(rng.uniform(0.2, 1.0, (D, N))),
        )
        y = np.array(j_sample_prior(jax.random.PRNGKey(b), jm, jp, T=T)[0])
        mask = np.ones(T, bool)
        mask[40 + 10 * b: 60 + 10 * b] = False
        if b == 1:
            y[100] = 50.0 * np.std(y)
        plist.append(jp)
        ys.append(y)
        masks.append(mask)
    return jm, plist, np.stack(ys), np.stack(masks)


@pytest.fixture(scope="module")
def files():
    return _toy_files()


def _port_params(jparams):
    """JAX params (single or stacked) -> the port's, float64 on the CPU."""
    return convert.params_from_numpy({k: np.asarray(v) for k, v in jparams._asdict().items()},
                                     device="cpu", dtype=torch.float64)


def _z_to_files(x):
    """(T, BF*C) z-major lanes -> (T, BF, C)."""
    z = x[:, : BF * D].reshape(-1, BF, D)
    g = x[:, BF * D:].reshape(-1, BF, N)
    return np.concatenate([z, g], axis=-1)


@pytest.mark.parametrize("link,variant,s_chunk", [
    ("softplus", "amp", 0), ("softplus", "sq", 7), ("exp", "amp", 7), ("exp", "sq", 0)])
def test_adf_mb_plain_matches_jax_interpret(files, link, variant, s_chunk):
    jm, plist, yB, maskB = files
    jm = jm._replace(link=link, variant=variant)
    if link == "exp":  # keep exp(g) in range for a prior-scale signal
        plist = [p._replace(mod_var=p.mod_var * 0.1) for p in plist]
    jpB = jbt.stack_params(plist)
    ssm_flat, WbdT = jbt._flat_model(jm, jpB)
    ms_b, Ps_b, lZ_j, sites_j = jpk.adf_filter_pallas_mb(
        jm.moment_params(), ssm_flat, WbdT, jpB.lik, jnp.asarray(yB.T), jnp.asarray(maskB.T),
        BF, 0.5, BLOCK, s_chunk, True)
    bs = ssm_flat.H.shape[1]
    # b-major rows (t, i) over z-major lanes -> (T, BF, C, bs)
    ms_j = _z_to_files(np.asarray(ms_b)[: T * bs]).reshape(T, bs, BF, D + N)
    ms_j = ms_j.transpose(0, 2, 3, 1)
    Ps_j = _z_to_files(np.asarray(Ps_b)[: T * bs * bs]).reshape(T, bs, bs, BF, D + N)
    Ps_j = Ps_j.transpose(0, 3, 4, 1, 2)

    model = GTNMFModel(*jm)
    pB = _port_params(jpB)
    ssmB = model.build_ssm_batch(pB)
    ms, Ps, lZ, sites = fk.adf_filter_fused_mb(
        model.moment_params(), ssmB, pB.W, pB.lik, torch.tensor(yB.T), torch.tensor(maskB.T),
        0.5, s_chunk)
    np.testing.assert_allclose(_np(ms), ms_j, rtol=1e-7, atol=1e-12)
    np.testing.assert_allclose(_np(Ps), Ps_j, rtol=1e-7, atol=1e-12)
    np.testing.assert_allclose(_np(sites.ttau), _z_to_files(np.asarray(sites_j.ttau)),
                               rtol=1e-7, atol=1e-12)
    np.testing.assert_allclose(_np(sites.tnu), _z_to_files(np.asarray(sites_j.tnu)),
                               rtol=1e-7, atol=1e-12)
    np.testing.assert_allclose(_np(lZ), np.asarray(lZ_j), rtol=1e-9)
    # masked steps: zero sites and lZ = 0; the outlier sits on the Z floor
    assert float(_np(sites.ttau)[45, 0].max()) == 0.0 and float(_np(lZ)[45, 0]) == 0.0
    if s_chunk == 0 and link == "softplus":
        assert _np(lZ)[100, 1] == pytest.approx(np.log(1e-10), rel=1e-12)


def test_adf_mb_plain_bf1_equals_single(files):
    jm, plist, yB, maskB = files
    model, p = GTNMFModel(*jm), _port_params(plist[1])
    mp = model.moment_params()
    y, mask = torch.tensor(yB[1]), torch.tensor(maskB[1])
    one = fk.adf_filter_fused(mp, model.build_ssm(p), p.W, p.lik, y, mask, 0.5)
    pB = stack_params([p])
    mb = fk.adf_filter_fused_mb(mp, model.build_ssm_batch(pB), pB.W, pB.lik, y[:, None],
                                mask[:, None], 0.5, 0)
    for a, b in zip((one[0], one[1], one[2], one[3].ttau, one[3].tnu),
                    (mb[0], mb[1], mb[2], mb[3].ttau, mb[3].tnu)):
        np.testing.assert_allclose(_np(b[:, 0]), _np(a), rtol=1e-12, atol=1e-12)


@pytest.fixture(scope="module")
def fused_batch(files):
    jm, plist, yB, maskB = files
    pB = _port_params(jbt.stack_params(plist))
    cfg = tep.EPConfig(ep_itts=3, backend="fused")
    res = tbt.ep_infer_batch(GTNMFModel(*jm), pB, torch.tensor(yB), torch.tensor(maskB), cfg,
                             device="cpu")
    return pB, cfg, res


def test_ep_batch_fused_matches_jax_pallas(files, fused_batch):
    jm, plist, yB, maskB = files
    _, _, res = fused_batch
    r_j = jbt.ep_infer_batch(jm, jbt.stack_params(plist), jnp.asarray(yB), jnp.asarray(maskB),
                             jep.EPConfig(ep_itts=3, backend="pallas", pallas_block=BLOCK))
    assert res.Eft.shape == (BF, T, D + N) and res.nlZ.shape == (BF, 3)
    np.testing.assert_allclose(_np(res.Eft), np.asarray(r_j.Eft), atol=1e-9)
    np.testing.assert_allclose(_np(res.Varft), np.asarray(r_j.Varft), atol=1e-9)
    np.testing.assert_allclose(_np(res.nlZ), np.asarray(r_j.nlZ), rtol=1e-9)
    np.testing.assert_allclose(_np(res.maxdiff)[:, 1:], np.asarray(r_j.maxdiff)[:, 1:],
                               rtol=1e-7, atol=1e-9)
    for a, b in zip(res.sites, r_j.sites):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-7, atol=1e-9)
    assert np.all(_np(res.Varft) > 0)


@pytest.mark.parametrize("b", range(BF))
def test_ep_batch_fused_matches_single_file(files, fused_batch, b):
    jm, _, yB, maskB = files
    pB, cfg, res = fused_batch
    r1 = tep.ep_infer(GTNMFModel(*jm), pB.select(b), torch.tensor(yB[b]),
                      torch.tensor(maskB[b]), cfg, device="cpu")
    np.testing.assert_allclose(_np(res.Eft[b]), _np(r1.Eft), atol=1e-9)
    np.testing.assert_allclose(_np(res.Varft[b]), _np(r1.Varft), atol=1e-9)
    np.testing.assert_allclose(_np(res.nlZ[b]), _np(r1.nlZ), rtol=1e-9)
    np.testing.assert_allclose(_np(res.maxdiff[b])[1:], _np(r1.maxdiff)[1:], rtol=1e-7)


def test_ep_batch_s_chunk_invariant(files, fused_batch):
    jm, _, yB, maskB = files
    pB, cfg, r0 = fused_batch
    r7 = tbt.ep_infer_batch(GTNMFModel(*jm), pB, torch.tensor(yB), torch.tensor(maskB),
                            cfg._replace(s_chunk=7), device="cpu")
    np.testing.assert_allclose(_np(r0.Eft), _np(r7.Eft), atol=1e-11)
    np.testing.assert_allclose(_np(r0.nlZ), _np(r7.nlZ), rtol=1e-11)


def test_ep_batch_seq_matches_jax_vmap(files):
    jm, plist, yB, maskB = files
    jpB = jbt.stack_params(plist[:2])
    r_j = jbt.ep_infer_batch(jm, jpB, jnp.asarray(yB[:2]), jnp.asarray(maskB[:2]),
                             jep.EPConfig(ep_itts=2))
    r_t = tbt.ep_infer_batch(GTNMFModel(*jm), _port_params(jpB), torch.tensor(yB[:2]),
                             torch.tensor(maskB[:2]), tep.EPConfig(ep_itts=2, backend="seq"),
                             device="cpu")
    np.testing.assert_allclose(_np(r_t.Eft), np.asarray(r_j.Eft), atol=1e-10)
    np.testing.assert_allclose(_np(r_t.Varft), np.asarray(r_j.Varft), atol=1e-10)
    np.testing.assert_allclose(_np(r_t.nlZ), np.asarray(r_j.nlZ), rtol=1e-10)


def test_infer_batch_dispatch(files, fused_batch):
    jm, _, yB, maskB = files
    pB, cfg, res = fused_batch
    model = GTNMFModel(*jm)
    args = (model, pB, torch.tensor(yB), torch.tensor(maskB))
    r = tbt.infer_batch("ep", *args, device="cpu", ep_itts=3, backend="fused")
    np.testing.assert_array_equal(_np(r.Eft), _np(res.Eft))
    # every "ihgp*" name is the batched IHGP engine; "giekf" the batched GIEKF
    ri = tbt.ihgp_infer_batch(*args, tih.IHGPConfig(ep_itts=2), device="cpu")
    assert ri.Eft.shape == (BF, T, D + N) and ri.nlZ.shape == (BF, 2)
    for engine in ("ihgp", "ihgp_tuned"):
        r = tbt.infer_batch(engine, *args, device="cpu", ep_itts=2)
        assert torch.equal(r.Eft, ri.Eft) and torch.equal(r.nlZ, ri.nlZ), engine
    rg = tbt.infer_batch("giekf", *args, device="cpu", g_iter=1, l_iter=1)
    assert rg.Eft.shape == (BF, T, D + N) and rg.nll.shape == (BF,)
    assert bool(torch.isfinite(rg.Eft).all())
    with pytest.raises(ValueError, match="unknown engine"):
        tbt.infer_batch("ekf", *args, device="cpu")


def test_stacked_params_and_trained_batch(files):
    _, plist, _, _ = files
    jpB = jbt.stack_params(plist)
    pB = _port_params(jpB)
    assert (pB.D, pB.N, pB.W.shape) == (D, N, (BF, D, N))
    for k, v in jpB._asdict().items():
        np.testing.assert_array_equal(_np(getattr(pB, k)), np.asarray(v))
        np.testing.assert_array_equal(_np(getattr(pB.select(2), k)), np.asarray(v)[2])
    same = stack_params([_port_params(p) for p in plist])
    np.testing.assert_array_equal(_np(same.W), _np(pB.W))

    paths = sorted(glob.glob(os.path.join(ROOT, "results/trained/music/trained_*_matern32.npz")))
    model, tB = convert.load_trained_batch(paths[:3], device="cpu", dtype=torch.float64)
    _, t1 = convert.load_trained(paths[1], device="cpu", dtype=torch.float64)
    assert tB.W.shape == (3, model.D, model.N) and tB.lik.shape == (3,)
    np.testing.assert_array_equal(_np(tB.select(1).omega), _np(t1.omega))
    ssmB = model.build_ssm_batch(tB)
    np.testing.assert_array_equal(_np(ssmB.A[1]), _np(model.build_ssm(t1).A))
    other = sorted(glob.glob(os.path.join(ROOT, "results/trained/source_sep/*.npz")))[0]
    with pytest.raises(ValueError, match="differs"):
        convert.load_trained_batch([paths[0], other], device="cpu")


@pytest.mark.parametrize("entry", ["adf_filter_fused", "filter_smoother_fused",
                                   "adf_filter_fused_mb"])
def test_fused_passes_refuse_a_nonstationary_start(files, entry):
    """The kernels start from (0, Pinf), exact only for Q = Pinf - A Pinf A'.
    A model whose Q is anything else must not reach them.  (The
    matrix-fraction discretization of these stationary kernels gives the same
    Q to rounding, so it passes; a process noise that does not balance Pinf
    does not.)"""
    jm, plist, yB, maskB = files
    model, p = GTNMFModel(*jm), _port_params(plist[0])
    mp = model.moment_params()
    args = (p.sub_var, p.sub_len, p.omega, p.mod_var, p.mod_len)
    kw = dict(kernel1=jm.kernel1, kernel2=jm.kernel2)
    good = tssm.build_modulator_ssm(*args, **kw)
    mf = tssm.build_modulator_ssm(*args, **kw, discretization="matrix_fraction")
    bad = mf._replace(Q=tssm.lti_disc_matrix_fraction(mf.F, 2.0 * mf.LQcLT)[1])
    y, mask = torch.tensor(yB[0, :16]), torch.tensor(maskB[0, :16])
    sites = tep.kalman.init_sites(16, D + N, torch.float64)

    def run(ssm):
        if entry == "adf_filter_fused":
            return fk.adf_filter_fused(mp, ssm, p.W, p.lik, y, mask, 0.5)
        if entry == "filter_smoother_fused":
            return fk.filter_smoother_fused(ssm, sites)
        return fk.adf_filter_fused_mb(mp, tssm.stack_ssms([ssm]), p.W[None], p.lik[None],
                                      y[:, None], mask[:, None], 0.5)

    run(good)
    run(mf)
    with pytest.raises(ValueError, match="stationary"):
        run(bad)
    # float32: rounding of a stationary model stays inside the 1e-5 bar
    fk.check_stationary(model.build_ssm(p.float()))
