"""Port parity: metrics, gap filling, the engine registry and the device
rule, float64 on the CPU.

- ``rmse`` / ``snr_db`` / ``make_gap_mask`` / ``reconstruct_signal`` (plug-in)
  equal the JAX functions to 1e-12; the MC path is reproducible from its seed.
- ``fill_gaps_batch`` against JAX ``fill_gaps_batch(engine="ep",
  backend="pallas")`` with ``n_samples=0``: 1e-8 on ``rmse_gaps`` and
  ``snr_gaps``; ``metric_gapsB`` is honoured; ``fill_gaps`` equals its row.
- ``registry.infer("ep")`` equals ``ep_infer``; unported engines raise.
- Every entry point that places tensors raises without a card when no
  device is given, and does not run on the CPU instead.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsgp_tpu.apps import missing_data as jmd
from nsgp_tpu.inference import batched as jbt
from nsgp_tpu.models.gtnmf import GTNMFModel as JModel
from nsgp_tpu.models.gtnmf import GTNMFParams as JParams
from nsgp_tpu.models.gtnmf import sample_prior as j_sample_prior
from nsgp_tpu.utils import metrics as jmetrics
from nsgp_tpu_torch import convert
from nsgp_tpu_torch.apps import missing_data as tmd
from nsgp_tpu_torch.apps import source_sep as tsep
from nsgp_tpu_torch.inference import batched as tbt
from nsgp_tpu_torch.inference import ep as tep
from nsgp_tpu_torch.inference import giekf as tgk
from nsgp_tpu_torch.inference import ihgp as tih
from nsgp_tpu_torch.inference import registry
from nsgp_tpu_torch.models.gtnmf import GTNMFModel, stack_params
from nsgp_tpu_torch.utils import metrics as tmetrics
from nsgp_tpu_torch.utils.device import resolve_device
from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAINED = os.path.join(ROOT, "results", "trained", "music", "trained_piano_matern32.npz")
BF, D, N, T = 2, 3, 2, 128
GAPS = [[(30, 12), (90, 20)], [(20, 8), (70, 25)]]


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _port_params(jparams):
    return convert.params_from_numpy({k: np.asarray(v) for k, v in jparams._asdict().items()},
                                     device="cpu", dtype=torch.float64)


@pytest.fixture(scope="module")
def files():
    jm = JModel(D=D, N=N, kernel1="matern32", kernel2="matern52", p_cubature=7, variant="sq")
    plist, ys = [], []
    for b in range(BF):
        rng = np.random.default_rng(b)
        jp = JParams(lik=jnp.asarray(0.03 + 0.01 * b), sub_var=jnp.linspace(0.5, 1.5, D),
                     sub_len=jnp.linspace(30.0, 90.0 + 5 * b, D),
                     omega=jnp.linspace(0.3, 1.4, D) * (1.0 + 0.03 * b),
                     mod_var=jnp.full((N,), 1.5), mod_len=jnp.linspace(250.0, 450.0, N),
                     W=jnp.asarray(rng.uniform(0.2, 1.0, (D, N))))
        plist.append(jp)
        ys.append(np.array(j_sample_prior(jax.random.PRNGKey(b), jm, jp, T=T)[0]))
    masks = np.stack([np.asarray(jmd.make_gap_mask(T, g)) for g in GAPS])
    return jm, plist, np.stack(ys), masks


def test_metrics_match_jax():
    rng = np.random.default_rng(0)
    a, b = rng.normal(size=(2, 50)), rng.normal(size=(2, 50))
    m = rng.uniform(size=(2, 50)) > 0.6
    for tf, jf in ((tmetrics.rmse, jmetrics.rmse), (tmetrics.snr_db, jmetrics.snr_db)):
        np.testing.assert_allclose(_np(tf(torch.tensor(a[0]), torch.tensor(b[0]))),
                                   np.asarray(jf(jnp.asarray(a[0]), jnp.asarray(b[0]))),
                                   rtol=1e-12)
        per_file = jax.vmap(jf)(jnp.asarray(a), jnp.asarray(b), jnp.asarray(m))
        np.testing.assert_allclose(_np(tf(torch.tensor(a), torch.tensor(b), torch.tensor(m))),
                                   np.asarray(per_file), rtol=1e-12)


def test_gap_mask_and_reconstruction_match_jax(files):
    jm, plist, _, masks = files
    for g, mask in zip(GAPS, masks):
        np.testing.assert_array_equal(_np(tmd.make_gap_mask(T, g)), mask)
    model, p = GTNMFModel(*jm), _port_params(plist[1])
    rng = np.random.default_rng(1)
    Eft, Var = rng.normal(size=(40, D + N)), rng.uniform(0.01, 0.2, size=(40, D + N))
    plug = tmd.reconstruct_signal(model, p, torch.tensor(Eft))
    np.testing.assert_allclose(
        _np(plug), np.asarray(jmd.reconstruct_signal(jm, plist[1], jnp.asarray(Eft))),
        rtol=1e-12, atol=1e-12)
    mc = lambda seed: _np(tmd.reconstruct_signal(
        model, p, torch.tensor(Eft), torch.tensor(Var), torch.Generator().manual_seed(seed), 64))
    np.testing.assert_array_equal(mc(5), mc(5))
    assert np.abs(mc(5) - mc(6)).max() > 0 and np.abs(mc(5) - _np(plug)).max() > 0


@pytest.fixture(scope="module")
def port_batch(files):
    jm, plist, yB, masks = files
    pB = _port_params(jbt.stack_params(plist))
    res = tmd.fill_gaps_batch(GTNMFModel(*jm), pB, torch.tensor(yB), torch.tensor(masks),
                              engine="ep", n_samples=0, device="cpu", ep_itts=3,
                              backend="fused")
    return pB, res


def test_fill_gaps_batch_matches_jax(files, port_batch):
    jm, plist, yB, masks = files
    _, res = port_batch
    r_j = jmd.fill_gaps_batch(jm, jbt.stack_params(plist), jnp.asarray(yB), jnp.asarray(masks),
                              engine="ep", n_samples=0, ep_itts=3, backend="pallas",
                              pallas_block=64)
    assert res.y_hat.shape == (BF, T) and res.rmse_gaps.shape == (BF,)
    np.testing.assert_allclose(_np(res.rmse_gaps), np.asarray(r_j.rmse_gaps), atol=1e-8)
    np.testing.assert_allclose(_np(res.snr_gaps), np.asarray(r_j.snr_gaps), atol=1e-8)
    np.testing.assert_allclose(_np(res.y_hat), np.asarray(r_j.y_hat), atol=1e-8)
    assert not hasattr(res.result, "ms")  # no dense trajectories in a batch result


def test_fill_gaps_batch_metric_gaps_and_single_file(files, port_batch):
    jm, _, yB, masks = files
    pB, res = port_batch
    model = GTNMFModel(*jm)
    scored = ~masks
    scored[:, 80:] = False  # score the first gap of each file only
    kw = dict(engine="ep", n_samples=0, device="cpu", ep_itts=3, backend="fused")
    r = tmd.fill_gaps_batch(model, pB, torch.tensor(yB), torch.tensor(masks),
                            metric_gapsB=torch.tensor(scored), **kw)
    np.testing.assert_array_equal(_np(r.y_hat), _np(res.y_hat))
    for b in range(BF):
        err = (yB[b] - _np(r.y_hat[b]))[scored[b]]
        assert float(r.rmse_gaps[b]) == pytest.approx(np.sqrt(np.mean(err**2)), rel=1e-12)
        assert float(r.rmse_gaps[b]) != float(res.rmse_gaps[b])
        one = tmd.fill_gaps(model, pB.select(b), torch.tensor(yB[b]), torch.tensor(masks[b]),
                            **kw)
        np.testing.assert_allclose(_np(one.y_hat), _np(res.y_hat[b]), atol=1e-9)
        np.testing.assert_allclose(float(one.rmse_gaps), float(res.rmse_gaps[b]), atol=1e-9)
        np.testing.assert_allclose(float(one.snr_gaps), float(res.snr_gaps[b]), atol=1e-8)


def test_fill_gaps_batch_monte_carlo_uses_one_generator_per_file(files, port_batch):
    jm, _, yB, masks = files
    pB, res = port_batch
    # two copies of file 0: same posterior, different noise
    twin = stack_params([pB.select(0), pB.select(0)])
    y2, m2 = torch.tensor(yB[[0, 0]]), torch.tensor(masks[[0, 0]])
    run = lambda seed: tmd.fill_gaps_batch(
        GTNMFModel(*jm), twin, y2, m2, engine="ep", n_samples=16, device="cpu", ep_itts=2,
        backend="fused", generator=torch.Generator().manual_seed(seed))
    a, b = run(3), run(3)
    np.testing.assert_array_equal(_np(a.y_hat), _np(b.y_hat))
    np.testing.assert_allclose(_np(a.result.Eft[0]), _np(a.result.Eft[1]), atol=1e-12)
    assert np.abs(_np(a.y_hat[0]) - _np(a.y_hat[1])).max() > 0
    assert np.abs(_np(a.y_hat) - _np(run(4).y_hat)).max() > 0


def test_registry_infer_is_ep_infer(files):
    jm, plist, yB, masks = files
    model, p = GTNMFModel(*jm), _port_params(plist[0])
    y, mask = torch.tensor(yB[0, :48]), torch.tensor(masks[0, :48])
    assert registry.ENGINES == ("ep", "ihgp", "giekf")
    fn, _, cfg_cls = registry.get_engine("ep")
    assert fn is tep.ep_infer and cfg_cls is tep.EPConfig
    r = registry.infer("ep", model, p, y, mask, device="cpu", ep_itts=2)
    r0 = tep.ep_infer(model, p, y, mask, tep.EPConfig(ep_itts=2), device="cpu")
    rc = registry.infer("ep", model, p, y, mask, config=tep.EPConfig(ep_itts=2), device="cpu")
    for f in ("Eft", "Varft", "nlZ"):
        np.testing.assert_array_equal(_np(getattr(r, f)), _np(getattr(r0, f)))
        np.testing.assert_array_equal(_np(getattr(rc, f)), _np(getattr(r0, f)))
    # IHGP is ported: the registry runs it with the same config rule
    ri = registry.infer("ihgp", model, p, y, mask, device="cpu", ep_itts=2)
    ri0 = tih.ihgp_infer(model, p, y, mask, tih.IHGPConfig(ep_itts=2), device="cpu")
    for f in ("Eft", "Varft", "nlZ"):
        np.testing.assert_array_equal(_np(getattr(ri, f)), _np(getattr(ri0, f)))
    # GIEKF is ported: the registry runs its inference with the config rule above
    rg = registry.infer("giekf", model, p, y[:16], mask[:16], device="cpu", g_iter=1)
    rg0 = tgk.giekf_infer(model, p, y[:16], mask[:16], tgk.GIEKFConfig(g_iter=1), device="cpu")
    np.testing.assert_array_equal(_np(rg.Eft), _np(rg0.Eft))
    with pytest.raises(ValueError, match="unknown engine"):
        registry.get_engine("ekf")


def _default_device_calls(files):
    jm, plist, yB, masks = files
    model = GTNMFModel(*jm)
    pB = _port_params(jbt.stack_params(plist))
    p = pB.select(0)
    y, mask, yBt, mBt = (torch.tensor(x) for x in (yB[0], masks[0], yB, masks))
    arrays = {k: np.asarray(v) for k, v in plist[0]._asdict().items()}
    cfg = tep.EPConfig(ep_itts=1, backend="fused")
    return {
        "params_from_numpy": lambda: convert.params_from_numpy(arrays),
        "load_trained": lambda: convert.load_trained(TRAINED),
        "load_trained_batch": lambda: convert.load_trained_batch([TRAINED]),
        "ep_infer": lambda: tep.ep_infer(model, p, y, mask, cfg),
        "ep_infer_batch": lambda: tbt.ep_infer_batch(model, pB, yBt, mBt, cfg),
        "infer_batch": lambda: tbt.infer_batch("ep", model, pB, yBt, mBt, cfg),
        "registry.infer": lambda: registry.infer("ep", model, p, y, mask, cfg),
        "separate": lambda: tsep.separate([model], [p], y, engine="ep", ep_itts=1),
        "fill_gaps": lambda: tmd.fill_gaps(model, p, y, mask, ep_itts=1),
        "fill_gaps_batch": lambda: tmd.fill_gaps_batch(model, pB, yBt, mBt, ep_itts=1),
    }


@pytest.mark.parametrize("entry", ["params_from_numpy", "load_trained", "load_trained_batch",
                                   "ep_infer", "ep_infer_batch", "infer_batch",
                                   "registry.infer", "separate", "fill_gaps",
                                   "fill_gaps_batch"])
def test_default_device_is_the_card_and_raises_without_one(files, entry, monkeypatch):
    """device=None means the card.  Where there is none the call raises at
    once: it must not reach the plain (CPU) passes."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves to it")
    from nsgp_tpu_torch.ops import fused_kalman as fk

    def no_cpu_run(*a, **k):
        raise AssertionError("ran on the CPU")

    for name in ("fused_fwd_plain", "fused_bwd_plain", "fused_adf_plain",
                 "fused_adf_mb_plain"):
        monkeypatch.setattr(fk, name, no_cpu_run)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _default_device_calls(files)[entry]()


def test_explicit_device_is_honoured():
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cpu")).type == "cpu"
    assert resolve_device("cuda:0") == torch.device("cuda", 0)  # named, not probed
