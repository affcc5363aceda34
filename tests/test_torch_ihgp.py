"""Port parity: the IHGP engine (``inference/ihgp.py``), its batched form and
training through it, and the log-depth scan it rests on; float64 on the CPU.

The same numpy inputs go through JAX and the port, on the toy model of
``tests/test_ihgp.py`` (D=3, N=2, matern32 subbands, matern52 modulators
padded into bs=4 blocks):

- ``ihgp_infer`` in its three forms, each against the same form in JAX, on a
  signal with a NaN gap, ``damping=(0.1, 0.025)`` and ``keep_best``: the
  sequential form, the blocked form with T = 100 and ``chunk=32`` (a ragged
  last chunk) and the one-level form.  Eft, Varft, lZ, sites, nlZ, maxdiff at
  rtol 1e-8 (relative to each field's max), grid indices equal.
- ``ihgp_energy``: the value at rtol 1e-10 and the gradient of every
  ``GTNMFParams`` leaf against ``jax.grad`` at rtol 1e-7; its graph never
  reaches ``eigh`` (the smoother tables).
- ``ihgp_infer_batch`` at BF=2 against JAX's, ``fit_hyperparams(engine=
  "ihgp")`` against JAX's (rtol 1e-6).
- ``associative_scan`` forward and reverse against a Python loop, with a
  non-commutative combine (2x2 matrix products).

The signals are seeded numpy draws (``_signal``).

JAX runs ``unroll=1`` (the same values, a smaller compile); each JAX program
compiles once per module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsgp_tpu.inference import batched as jbt
from nsgp_tpu.inference import ihgp as jih
from nsgp_tpu.inference import learn as jlearn
from nsgp_tpu.models.gtnmf import GTNMFModel as JModel
from nsgp_tpu.models.gtnmf import GTNMFParams as JParams
from nsgp_tpu_torch.convert import params_from_numpy
from nsgp_tpu_torch.inference import batched as tbt
from nsgp_tpu_torch.inference import ihgp as tih
from nsgp_tpu_torch.inference import learn as tlearn
from nsgp_tpu_torch.models.gtnmf import PARAM_NAMES, GTNMFModel, GTNMFParams, stack_params
from nsgp_tpu_torch.ops.pscan import associative_scan
from torch_threads import one_torch_thread  # noqa: F401

T = 100
CHUNK = 32  # 100 = 3 * 32 + 4: a ragged last chunk
FORMS = {
    "seq": dict(keep_best=True),
    "blocked": dict(parallel=True, chunk=CHUNK),
    "one_level": dict(parallel=True, chunk=0, keep_best=True),
}
COMMON = dict(ep_itts=2, damping=(0.1, 0.025))
SPECS = {"lik": "fixed", "omega": "fixed", "mod_len": (100.0, 1000.0)}


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _jparams(seed=0):
    return JParams(lik=jnp.asarray(0.05), sub_var=jnp.linspace(0.5, 1.5, 3),
                   sub_len=jnp.linspace(30.0, 90.0, 3), omega=jnp.linspace(0.2, 1.2, 3),
                   mod_var=jnp.full((2,), 1.5 + 0.25 * seed), mod_len=jnp.asarray([300.0, 500.0]),
                   W=jax.random.uniform(jax.random.PRNGKey(seed), (3, 2), minval=0.2,
                                        maxval=1.0))


def _port(jp):
    return params_from_numpy({k: np.asarray(v) for k, v in jp._asdict().items()},
                             device="cpu", dtype=torch.float64)


def _signal(seed, T_):
    """A seeded numpy signal in the toy's bands: carriers at its centre
    frequencies under slow positive envelopes, plus noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(T_)
    env = lambda: 0.3 + np.abs(np.cumsum(rng.normal(size=T_))) / np.sqrt(T_)
    y = sum(env() * np.cos(om * t + rng.uniform(0, 2 * np.pi)) for om in (0.2, 0.7, 1.2))
    return y + 0.2 * rng.normal(size=T_)


@pytest.fixture(scope="module")
def toy():
    jm = JModel(D=3, N=2, kernel1="matern32", kernel2="matern52", p_cubature=7)
    jp = _jparams()
    y = _signal(42, T)
    y[40:50] = np.nan
    return jm, jp, GTNMFModel(*jm), _port(jp), y


@pytest.fixture(scope="module")
def jax_runs(toy):
    jm, jp, _, _, y = toy
    return {form: jih.ihgp_infer(jm, jp, jnp.asarray(y), None,
                                 jih.IHGPConfig(unroll=1, **COMMON, **kw))
            for form, kw in FORMS.items()}


def _assert_result(r_t, r_j, rtol=1e-8):
    for f in ("Eft", "Varft", "lZ", "nlZ", "maxdiff"):
        a, b = _np(getattr(r_t, f)), np.asarray(getattr(r_j, f))
        assert a.shape == b.shape, f
        np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b), err_msg=f)
        fin = np.isfinite(b)
        np.testing.assert_allclose(a[fin], b[fin], rtol=rtol, atol=rtol * np.abs(b[fin]).max(),
                                   err_msg=f)
    for a, b in zip(r_t.sites, r_j.sites):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=rtol,
                                   atol=rtol * np.abs(np.asarray(b)).max())


@pytest.mark.parametrize("form", list(FORMS))
def test_ihgp_infer_matches_jax(toy, jax_runs, form):
    jm, jp, model, params, y = toy
    cfg = tih.IHGPConfig(**COMMON, **FORMS[form])
    r_t = tih.ihgp_infer(model, params, torch.tensor(y), None, cfg, device="cpu")
    r_j = jax_runs[form]
    _assert_result(r_t, r_j)
    assert r_t.Eft.shape == (T, 5) and r_t.maxdiff[0].item() == float("inf")
    assert np.all(np.isfinite(_np(r_t.Eft))) and np.all(_np(r_t.Varft) > 0)
    # the grid indices of the final sites, from each package's own sites
    cfg_j = jih.IHGPConfig(**COMMON, **FORMS[form])
    log_r = np.linspace(cfg_j.grid_lo, cfg_j.grid_hi, cfg_j.grid_fine)
    tb_j = jih.IHGPTables(log_r=jnp.asarray(log_r), Ph=None, Gn=None, hPph=None, hPSh=None)
    obs = ~np.isnan(y)[:, None]
    idx_j = jih._lookup_idx(tb_j, jnp.where(obs, r_j.sites.ttau, 0.0))
    lk = tih._lookup_consts(tih.IHGPTables(torch.tensor(log_r), None, None, None, None))
    idx_t = tih._lookup_idx(lk, torch.where(torch.tensor(obs), r_t.sites.ttau, 0.0))
    assert len(np.unique(np.asarray(idx_j))) > 3
    np.testing.assert_array_equal(_np(idx_t), np.asarray(idx_j))


def test_forms_agree_and_the_ragged_tail_is_trimmed(toy):
    """The blocked form with a chunk that does not divide T, and with one
    that does, give the one-level form's smoothed means (the same affine
    recursions, composed in another order)."""
    _, _, model, params, y = toy
    run = lambda **kw: tih.ihgp_infer(model, params, torch.tensor(y), None,
                                      tih.IHGPConfig(**COMMON, parallel=True, **kw), device="cpu")
    ref = run(chunk=0)
    for chunk in (CHUNK, 25, 7, 200):
        r = run(chunk=chunk)
        assert r.Eft.shape == ref.Eft.shape
        np.testing.assert_allclose(_np(r.Eft), _np(ref.Eft), rtol=1e-9,
                                   atol=1e-11 * np.abs(_np(ref.Eft)).max())


def test_ihgp_energy_and_gradient_match_jax(toy, monkeypatch):
    jm, jp, model, params, y = toy
    y = y[:64]
    e_j, g_j = jax.value_and_grad(
        lambda p: jih.ihgp_energy(jm, p, jnp.asarray(y), None, jih.IHGPConfig(unroll=1)))(jp)

    def no_eigh(*a, **k):
        raise AssertionError("ihgp_energy reached the smoother tables")

    monkeypatch.setattr(torch.linalg, "eigh", no_eigh)
    leaves = {k: getattr(params, k).clone().requires_grad_(True) for k in PARAM_NAMES}
    e_t = tih.ihgp_energy(model, GTNMFParams(**leaves), torch.tensor(y), None, device="cpu")
    g_t = dict(zip(PARAM_NAMES, torch.autograd.grad(e_t, list(leaves.values()))))
    assert e_t.shape == () and e_t.dtype == torch.float64
    np.testing.assert_allclose(e_t.item(), float(e_j), rtol=1e-10)
    for k in PARAM_NAMES:
        ref = np.asarray(getattr(g_j, k))
        assert np.all(np.isfinite(ref)) and np.abs(ref).max() > 0, k
        np.testing.assert_allclose(g_t[k].numpy(), ref, rtol=1e-7,
                                   atol=1e-12 * np.abs(ref).max(), err_msg=k)


def test_ihgp_infer_batch_matches_jax(toy):
    jm, _, model, _, _ = toy
    jps = [_jparams(1), _jparams(2)]
    yB = np.stack([_signal(10 + b, 64) for b in range(2)])
    yB[1, 20:30] = np.nan
    cfg = dict(ep_itts=2, damping=(0.1,), parallel=True, chunk=16)
    jpB = jbt.stack_params(jps)
    r_j = jbt.ihgp_infer_batch(jm, jpB, jnp.asarray(yB), None, jih.IHGPConfig(unroll=1, **cfg))
    pB = stack_params([_port(p) for p in jps])
    r_t = tbt.ihgp_infer_batch(model, pB, torch.tensor(yB), None, tih.IHGPConfig(**cfg),
                               device="cpu")
    assert r_t.Eft.shape == (2, 64, 5) and r_t.nlZ.shape == (2, 2)
    _assert_result(r_t, r_j)
    # the engine names of the corpus experiments all reach it
    r2 = tbt.infer_batch("ihgp_ref", model, pB, torch.tensor(yB), device="cpu", **cfg)
    assert torch.equal(r2.Eft, r_t.Eft) and torch.equal(r2.sites.ttau, r_t.sites.ttau)


def test_fit_hyperparams_through_ihgp_matches_jax(toy):
    jm, jp, model, params, y = toy
    y = y[:48]
    fit_j = jlearn.fit_hyperparams(jm, jp, jnp.asarray(y), engine="ihgp", specs=SPECS, steps=2,
                                   learning_rate=1e-2, unroll=1)
    fit_t = tlearn.fit_hyperparams(model, params, torch.tensor(y), engine="ihgp", specs=SPECS,
                                   steps=2, learning_rate=1e-2, device="cpu", unroll=1)
    np.testing.assert_allclose(fit_t.energies.numpy(), np.asarray(fit_j.energies), rtol=1e-6)
    for g in tlearn.GROUPS:
        np.testing.assert_allclose(getattr(fit_t.params, g).numpy(),
                                   np.asarray(getattr(fit_j.params, g)), rtol=1e-6, err_msg=g)
    # without kwargs the energy is the IHGPConfig defaults', as in JAX
    e = tlearn.make_energy_fn(model, torch.tensor(y), engine="ihgp", device="cpu")(params)
    assert e.item() == tih.ihgp_energy(model, params, torch.tensor(y), device="cpu").item()


def test_entry_points_follow_the_device_rule(toy):
    _, _, model, params, y = toy
    r = tih.ihgp_infer(model, params, torch.tensor(y[:16]), None, tih.IHGPConfig(ep_itts=1),
                       device="cpu")
    assert r.Eft.device.type == "cpu"
    if not torch.cuda.is_available():
        for fn in (tih.ihgp_infer, tih.ihgp_energy):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                fn(model, params, torch.tensor(y[:16]))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tbt.ihgp_infer_batch(model, stack_params([params]), torch.tensor(y[None, :16]))


def _loop_scan(combine, elems, reverse):
    n = elems[0].shape[0]
    order = range(n - 1, -1, -1) if reverse else range(n)
    out, acc = [None] * n, None
    for k in order:
        e = tuple(x[k:k + 1] for x in elems)
        acc = e if acc is None else combine(acc, e)
        out[k] = acc
    return tuple(torch.cat(xs) for xs in zip(*out))


@pytest.mark.parametrize("reverse", [False, True])
def test_associative_scan_matches_a_loop(reverse):
    """Matrix products do not commute, so the argument order under
    ``reverse`` (JAX's: the suffix first) is pinned."""
    rng = np.random.default_rng(3)
    combine = lambda a, b: (b[0] @ a[0], (b[0] @ a[1][..., None])[..., 0] + b[1])
    for n in (1, 2, 3, 4, 5, 8, 13):
        elems = (torch.tensor(rng.normal(size=(n, 2, 2))), torch.tensor(rng.normal(size=(n, 2))))
        got = associative_scan(combine, elems, reverse=reverse)
        want = _loop_scan(combine, elems, reverse)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-12, atol=1e-12)
