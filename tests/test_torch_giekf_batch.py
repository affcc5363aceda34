"""Port parity: batched GIEKF (``inference/batched.py:giekf_infer_batch``),
float64 on the CPU.

- ``giekf_infer_batch`` against JAX ``batched.giekf_infer_batch`` on the same
  numpy inputs: three files of one structure (D=4, N=2, dense m = 18), masks
  with gaps at different places and a padded tail that differs per file,
  three global passes with two inner iterations, at 1e-10 (relative to each
  output's max), as ``tests/test_batched.py`` holds JAX's batch to its
  single-file engine;
- the batch against the port's single-file ``giekf_infer`` file by file;
- the pass gate per file: a file made non-finite on pass 2 keeps its pass-1
  posterior while its neighbour takes pass 2;
- ``infer_batch("giekf")`` and ``fill_gaps_batch(engine="giekf")``, which
  drops the dense trajectories.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsgp_tpu.inference import batched as jbt
from nsgp_tpu.inference import giekf as jg
from nsgp_tpu.models.gtnmf import GTNMFModel as JModel
from nsgp_tpu.models.gtnmf import GTNMFParams as JParams
from nsgp_tpu_torch.apps import missing_data as tmd
from nsgp_tpu_torch.convert import params_from_numpy
from nsgp_tpu_torch.inference import batched as tbt
from nsgp_tpu_torch.inference import giekf as tg
from nsgp_tpu_torch.models.gtnmf import GTNMFModel
from torch_threads import one_torch_thread  # noqa: F401

BF, D, N, T = 3, 4, 2, 160
CFG = dict(g_iter=3, l_iter=2)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.fixture(scope="module")
def files():
    """Three files: hyperparameters that differ, seeded numpy signals (a sum
    of damped tones), a gap at a different place in each, and a tail of
    padding (mask False) of a different length in each."""
    jm = JModel(D=D, N=N, kernel1="exp", kernel2="matern52", p_cubature=7)
    arrays, ys, masks = [], [], []
    t = np.arange(T)
    for b in range(BF):
        rng = np.random.default_rng(31 + b)
        arrays.append(dict(
            lik=np.asarray(0.05 + 0.01 * b), sub_var=np.linspace(0.5, 1.5 + 0.2 * b, D),
            sub_len=np.linspace(30.0, 90.0 + 5 * b, D),
            omega=np.linspace(0.2, 1.2, D) * (1.0 + 0.03 * b),
            mod_var=np.full(N, 1.5 + 0.1 * b), mod_len=np.linspace(200.0, 400.0, N),
            W=rng.uniform(0.2, 1.0, (D, N))))
        y = sum(np.sin(w * t + rng.uniform(0, 6)) for w in arrays[-1]["omega"][:2])
        ys.append(y * (1.0 + 0.3 * np.sin(t / 40.0)) + 0.2 * rng.normal(size=T))
        mask = np.ones(T, bool)
        mask[20 + 30 * b: 34 + 30 * b] = False
        mask[T - 12 * b:] = False  # padding: none, 12 and 24 steps
        masks.append(mask)
    pB = {k: np.stack([a[k] for a in arrays]) for k in arrays[0]}
    return jm, pB, np.stack(ys), np.stack(masks)


@pytest.fixture(scope="module")
def jax_batch(files):
    jm, pB, yB, maskB = files
    jpB = JParams(**{k: jnp.asarray(v) for k, v in pB.items()})
    return jbt.giekf_infer_batch(jm, jpB, jnp.asarray(yB), jnp.asarray(maskB),
                                 jg.GIEKFConfig(**CFG))


@pytest.fixture(scope="module")
def port_batch(files):
    jm, pB, yB, maskB = files
    res = tbt.giekf_infer_batch(GTNMFModel(*jm), params_from_numpy(pB, device="cpu"),
                                torch.tensor(yB), torch.tensor(maskB), tg.GIEKFConfig(**CFG),
                                device="cpu")
    return res


def test_giekf_batch_matches_jax(jax_batch, port_batch):
    assert port_batch.ms.shape == (BF, T, (D + N) * 3)
    assert port_batch.Ps.shape == (BF, T, (D + N) * 3, (D + N) * 3)
    for name in ("Eft", "Varft", "nll", "ms", "Ps"):
        got, want = getattr(port_batch, name).numpy(), np.asarray(getattr(jax_batch, name))
        assert got.shape == want.shape, name
        assert _rel(got, want) <= 1e-10, (name, _rel(got, want))


def test_giekf_batch_matches_single_file(files, port_batch):
    jm, pB, yB, maskB = files
    params = params_from_numpy(pB, device="cpu")
    for b in range(BF):
        r1 = tg.giekf_infer(GTNMFModel(*jm), params.select(b), torch.tensor(yB[b]),
                            torch.tensor(maskB[b]), tg.GIEKFConfig(**CFG), device="cpu")
        for name in ("Eft", "Varft", "nll"):
            assert _rel(getattr(port_batch, name)[b], getattr(r1, name)) <= 1e-11, (b, name)


def test_nonfinite_pass_keeps_the_files_last_kept_pass(files, monkeypatch):
    """accept_tol < 0: only finiteness gates.  Pass 2's smoother is made NaN
    for file 0 alone; file 0 must equal a one-pass run, file 1 a two-pass
    run (and pass 2 must have moved it)."""
    jm, pB, yB, maskB = files
    params = params_from_numpy({k: v[:2] for k, v in pB.items()}, device="cpu")
    args = (GTNMFModel(*jm), params, torch.tensor(yB[:2]), torch.tensor(maskB[:2]))
    run = lambda g: tbt.giekf_infer_batch(*args, tg.GIEKFConfig(g_iter=g, l_iter=1,
                                                                accept_tol=-1.0), device="cpu")
    one, two = run(1), run(2)
    real = tbt._rts_dense_batch
    calls = []

    def poisoned(A, Q, ms, Ps, jitter):
        ms_s, Ps_s = real(A, Q, ms, Ps, jitter)
        calls.append(1)
        if len(calls) == 2:
            ms_s = ms_s.clone()
            ms_s[0, T // 2] = float("nan")
        return ms_s, Ps_s

    monkeypatch.setattr(tbt, "_rts_dense_batch", poisoned)
    r = run(2)
    assert len(calls) == 2
    assert torch.equal(r.Eft[0], one.Eft[0]) and torch.equal(r.nll[0], one.nll[0])
    assert torch.equal(r.Eft[1], two.Eft[1]) and torch.equal(r.nll[1], two.nll[1])
    assert not torch.equal(two.Eft[1], one.Eft[1])
    assert bool(torch.isfinite(r.Eft).all())


def test_infer_batch_and_fill_gaps_batch(files, port_batch):
    jm, pB, yB, maskB = files
    model, params = GTNMFModel(*jm), params_from_numpy(pB, device="cpu")
    yt, mt = torch.tensor(yB), torch.tensor(maskB)
    r = tbt.infer_batch("giekf", model, params, yt, mt, device="cpu", **CFG)
    assert torch.equal(r.Eft, port_batch.Eft) and torch.equal(r.nll, port_batch.nll)
    g = tmd.fill_gaps_batch(model, params, yt, mt, engine="giekf", n_samples=0, device="cpu",
                            **CFG)
    assert g.result.ms is None and g.result.Ps is None
    assert torch.equal(g.result.Eft, port_batch.Eft)
    assert g.rmse_gaps.shape == (BF,) and bool(torch.isfinite(g.rmse_gaps).all())
