"""Port parity: ``ep_infer`` end to end, float64 on the CPU.

- ``backend="seq"`` (counterpart of JAX's "xla") against the golden
  posterior ``tests/golden/ep_toy.npz`` at atol 1e-9, as test_golden.py
  holds the JAX engine;
- ``backend="fused"`` (counterpart of JAX's "pallas"; on CPU tensors its
  passes run as the kernels' plain versions) against JAX ``backend="pallas"``
  (Pallas interpret mode) on a clean signal, a NaN gap and a 50-sigma
  outlier, at the Pallas kernels' bar rtol 1e-7 / atol 1e-9 and nlZ rtol
  1e-9.  Each port backend is held against its own JAX counterpart only:
  the two handle the last site differently.
"""

import os
import sys

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
from nsgp_tpu_torch.models.gtnmf import GTNMFModel
from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden", "ep_toy.npz")
PALLAS = dict(rtol=1e-7, atol=1e-9)
T = 256


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _port(jm, jp):
    return GTNMFModel(*jm), params_from_numpy(
        {k: np.asarray(v) for k, v in jp._asdict().items()}, device="cpu", dtype=torch.float64)


def test_seq_backend_reproduces_golden():
    """Parameters as scripts/make_golden.py:toy() builds them; its prior
    sample is the fixture's y (test_golden.py checks that)."""
    sys.path.insert(0, ROOT)
    from scripts.make_golden import D, N, SEED

    g = np.load(GOLDEN)
    jm = JModel(D=D, N=N, kernel1="matern32", kernel2="matern52", p_cubature=9)
    jp = JParams(lik=jnp.asarray(1e-3), sub_var=jnp.ones((D,)),
                 sub_len=jnp.linspace(40.0, 120.0, D), omega=jnp.linspace(0.1, 2.2, D),
                 mod_var=jnp.full((N,), 2.0), mod_len=jnp.linspace(200.0, 400.0, N),
                 W=jax.random.uniform(jax.random.PRNGKey(SEED), (D, N), minval=0.1,
                                      maxval=1.0))
    model, params = _port(jm, jp)
    r = tep.ep_infer(model, params, torch.tensor(g["y"]), None,
                     tep.EPConfig(ep_itts=5, backend="seq"), device="cpu")
    np.testing.assert_allclose(_np(r.Eft), g["Eft"], atol=1e-9)
    np.testing.assert_allclose(_np(r.Varft), g["Varft"], atol=1e-9)
    np.testing.assert_allclose(_np(r.nlZ), g["nlZ"], rtol=1e-9)
    np.testing.assert_allclose(_np(r.maxdiff)[1:], g["maxdiff"][1:], rtol=1e-6, atol=1e-12)


def _toy(D=3, N=2):
    rng = np.random.default_rng(0)
    jm = JModel(D=D, N=N, kernel1="matern32", kernel2="matern52")
    jp = JParams(lik=jnp.asarray(0.05), sub_var=jnp.linspace(0.5, 1.5, D),
                 sub_len=jnp.linspace(20.0, 80.0, D), omega=jnp.linspace(0.1, 1.0, D),
                 mod_var=jnp.full((N,), 1.5), mod_len=jnp.linspace(300.0, 600.0, N),
                 W=jnp.asarray(rng.uniform(0.2, 1.0, (D, N))))
    return jm, jp


def _signal(jm, jp, case):
    seed = {"clean": 5, "nan_gap": 7, "outlier": 9}[case]
    y, _, _ = j_sample_prior(jax.random.PRNGKey(seed), jm, jp, T=T)
    y = np.array(y)
    if case == "nan_gap":
        y[60:90] = np.nan
    elif case == "outlier":  # drives the raw Z under its floor (speech6 onsets)
        y[128] = 50.0 * np.std(y)
    return y


@pytest.mark.parametrize("case", ["clean", "nan_gap", "outlier"])
def test_fused_backend_matches_jax_pallas(case):
    """One JAX compile serves all cases (same shapes and config)."""
    jm, jp = _toy()
    y = _signal(jm, jp, case)
    r_j = jep.ep_infer(jm, jp, jnp.asarray(y), None,
                       jep.EPConfig(ep_itts=3, backend="pallas", pallas_block=64))
    model, params = _port(jm, jp)
    r_t = tep.ep_infer(model, params, torch.tensor(y), None,
                       tep.EPConfig(ep_itts=3, backend="fused"), device="cpu")
    for f in ("Eft", "Varft", "lZ", "ms", "Ps"):
        a, b = _np(getattr(r_t, f)), np.asarray(getattr(r_j, f))
        assert a.shape == b.shape, f
        np.testing.assert_allclose(a, b, **PALLAS, err_msg=f)
    for a, b in zip(r_t.sites, r_j.sites):
        np.testing.assert_allclose(_np(a), np.asarray(b), **PALLAS)
    np.testing.assert_allclose(_np(r_t.nlZ), np.asarray(r_j.nlZ), rtol=1e-9)
    np.testing.assert_allclose(_np(r_t.maxdiff)[1:], np.asarray(r_j.maxdiff)[1:], **PALLAS)
    assert np.all(np.isfinite(_np(r_t.Eft))) and np.all(_np(r_t.Varft) > 0)


@pytest.mark.parametrize("field,value", [("parallel", True), ("jitter", 1e-6)])
def test_ported_config_fields_match_jax(field, value):
    """``parallel`` with ``chunk=0`` (the one-level log-depth scans) and
    ``jitter`` run, on ``backend="seq"``, against JAX's ``ep_infer`` at rtol
    1e-8 (the jitter on the one-level path, the only one where JAX's acts;
    the T=32 signal has a NaN gap)."""
    jm, jp = _toy()
    model, params = _port(jm, jp)
    kw = {field: value, "parallel": True, "chunk": 0, "ep_itts": 2}
    y = _signal(jm, jp, "nan_gap")[50:82]
    r_j = jep.ep_infer(jm, jp, jnp.asarray(y), None, jep.EPConfig(unroll=1, **kw))
    r_t = tep.ep_infer(model, params, torch.tensor(y), None, tep.EPConfig(**kw),
                       device="cpu")
    for f in ("Eft", "Varft", "lZ", "nlZ", "ms", "Ps"):
        b = np.asarray(getattr(r_j, f))
        np.testing.assert_allclose(_np(getattr(r_t, f)), b, rtol=1e-8,
                                   atol=1e-8 * np.abs(b).max(), err_msg=f)
    for a, b in zip(r_t.sites, r_j.sites):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-8,
                                   atol=1e-8 * np.abs(np.asarray(b)).max())


@pytest.mark.parametrize("field,value", [("chunk", 256), ("channel_axis", "c"),
                                         ("time_axis", "t")])
def test_unported_config_fields_raise(field, value):
    """A field set without the option that reads it raises: ``chunk`` without
    ``parallel`` raises ``NotImplementedError``.  ``channel_axis`` and
    ``time_axis`` are ported (``tests/test_torch_mesh.py``): set without an
    ambient mesh they raise ``RuntimeError``, as JAX's sharding constraint
    does (``time_axis`` on the blocked path, the one that reads it)."""
    jm, jp = _toy()
    model, params = _port(jm, jp)
    kw = {field: value}
    y = torch.zeros(8, dtype=torch.float64)
    if field in ("channel_axis", "time_axis"):
        if field == "time_axis":
            kw.update(parallel=True, chunk=4)
        with pytest.raises(RuntimeError):
            jep.ep_infer(jm, jp, jnp.asarray(y.numpy()), None, jep.EPConfig(unroll=1, **kw))
        with pytest.raises(RuntimeError, match="ambient mesh"):
            tep.ep_infer(model, params, y, None, tep.EPConfig(**kw), device="cpu")
        return
    with pytest.raises(NotImplementedError, match=field):
        tep.ep_infer(model, params, y, None, tep.EPConfig(**kw), device="cpu")


def test_jitter_is_ignored_where_jax_ignores_it():
    """JAX's ``jitter`` acts on the one-level path only: its blocked, Pallas
    and sequential sweeps and its energy ignore it, and so do the port's
    (the same bits as without it)."""
    jm, jp = _toy()
    model, params = _port(jm, jp)
    y = torch.tensor(_signal(jm, jp, "nan_gap")[40:88])
    for kw in (dict(), dict(backend="fused"), dict(parallel=True, chunk=16)):
        r0 = tep.ep_infer(model, params, y, None, tep.EPConfig(ep_itts=2, **kw), device="cpu")
        r1 = tep.ep_infer(model, params, y, None, tep.EPConfig(ep_itts=2, jitter=1e-3, **kw),
                          device="cpu")
        assert torch.equal(r0.Eft, r1.Eft) and torch.equal(r0.nlZ, r1.nlZ), kw
    r0 = tep.ep_infer(model, params, y, None, tep.EPConfig(ep_itts=2, parallel=True, chunk=0),
                      device="cpu")
    r1 = tep.ep_infer(model, params, y, None,
                      tep.EPConfig(ep_itts=2, parallel=True, chunk=0, jitter=1e-3), device="cpu")
    assert not torch.equal(r0.Varft, r1.Varft)  # where it acts, it acts


def test_parallel_is_refused_on_the_fused_backend():
    model, params = _port(*_toy(D=2, N=1))
    y = torch.zeros(8, dtype=torch.float64)
    with pytest.raises(NotImplementedError, match="parallel"):
        tep.ep_infer(model, params, y, None, tep.EPConfig(parallel=True, backend="fused"),
                     device="cpu")


def test_parallel_blocked_matches_jax_parallel():
    """``EPConfig(parallel=True, chunk=16)`` on ``backend="seq"`` (sweep 1
    sequential ADF, then the blocked scans of ``ops.bscan`` and the all-T
    re-site) against the JAX package's parallel path: the golden toy model
    and the first 520 samples of its signal (not a multiple of the chunk)."""
    sys.path.insert(0, ROOT)
    from scripts.make_golden import D, N, SEED

    y = np.load(GOLDEN)["y"][:520]
    jm = JModel(D=D, N=N, kernel1="matern32", kernel2="matern52", p_cubature=9)
    jp = JParams(lik=jnp.asarray(1e-3), sub_var=jnp.ones((D,)),
                 sub_len=jnp.linspace(40.0, 120.0, D), omega=jnp.linspace(0.1, 2.2, D),
                 mod_var=jnp.full((N,), 2.0), mod_len=jnp.linspace(200.0, 400.0, N),
                 W=jax.random.uniform(jax.random.PRNGKey(SEED), (D, N), minval=0.1,
                                      maxval=1.0))
    r_j = jep.ep_infer(jm, jp, jnp.asarray(y), None,
                       jep.EPConfig(ep_itts=3, parallel=True, chunk=16))
    model, params = _port(jm, jp)
    r_t = tep.ep_infer(model, params, torch.tensor(y), None,
                       tep.EPConfig(ep_itts=3, parallel=True, chunk=16), device="cpu")
    for f in ("Eft", "Varft", "lZ", "ms", "Ps"):
        np.testing.assert_allclose(_np(getattr(r_t, f)), np.asarray(getattr(r_j, f)),
                                   rtol=1e-7, atol=1e-9, err_msg=f)
    np.testing.assert_allclose(_np(r_t.nlZ), np.asarray(r_j.nlZ), rtol=1e-9)


def test_backend_and_device_are_checked():
    model, params = _port(*_toy(D=2, N=1))
    y = torch.zeros(8, dtype=torch.float64)
    with pytest.raises(ValueError, match="backend"):
        tep.ep_infer(model, params, y, None, tep.EPConfig(backend="pallas"), device="cpu")
    # inputs follow the device asked for: parameters held elsewhere are moved,
    # not refused, and the caller's copy stays where it was
    r = tep.ep_infer(model, params, y, torch.ones(8, dtype=torch.bool),
                     tep.EPConfig(ep_itts=1, backend="fused"), device=torch.device("cpu"))
    assert r.Eft.device.type == "cpu" and params.lik.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tep.ep_infer(model, params, y, None, tep.EPConfig(backend="fused"))
