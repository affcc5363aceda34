"""The training step's sync-free assembly on the CPU, in float64.

``ops.ssm.expm``, the matrix exponential both discretizations take, against
``torch.linalg.matrix_exp`` in value and in gradient, on every trained
music and speech model and on the corners of the training boxes
(``train_hyperopt.SPECS``); its cover, and the NaN it writes beyond it,
which the stationarity check refuses.  Then the deferral of that check in
``fit_hyperparams``: one read when the steps end, one count a step, and an
immediate read outside a scope.  The card test of "no sync in a step" is
``tests/test_torch_cuda.py::test_fit_steps_never_sync``.
"""

import glob
import itertools
import math
import os

import pytest
import torch

from nsgp_tpu_torch.convert import load_trained
from nsgp_tpu_torch.experiments.train_hyperopt import SPECS
from nsgp_tpu_torch.inference.learn import fit_hyperparams
from nsgp_tpu_torch.models.gtnmf import GTNMFModel, GTNMFParams
from nsgp_tpu_torch.ops import fused_kalman as fk
from nsgp_tpu_torch.ops import ssm
from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F64 = torch.float64
# Both exponentials are the same degree-18 Taylor scheme and each lies within
# 8.3 ulp of the 40-digit value on these models; they differ in summation
# order only.  Widest gap seen over the cases below: 10.7 ulp (the
# matrix-fraction block at a box corner).
ULPS = 16
GRAD_RTOL = 1e-12


def _trained(corpus):
    return sorted(glob.glob(os.path.join(ROOT, "results", "trained", corpus, "*.npz")))


def _block(F, LQcLT, disc):
    """What each discretization exponentiates: F, or the matrix-fraction
    block [[F, L Qc L'], [0, -F']]."""
    if disc == "stationary":
        return F
    return torch.cat([torch.cat([F, LQcLT], -1),
                      torch.cat([torch.zeros_like(F), -F.transpose(-1, -2)], -1)], -2)


def _blocks(corpus, disc):
    """Every block of every trained model of ``corpus``, and of each model
    with its tuned groups at the corners of the ``SPECS`` boxes: a list of
    (C, n, n), n by the model's kernels."""
    out = []
    for path in _trained(corpus):
        model, p = load_trained(path, device="cpu", dtype=F64)
        D, N = model.D, model.N
        builds = [(p.sub_len, p.mod_var, p.mod_len)]
        builds += [(torch.full((D,), a, dtype=F64), torch.full((N,), b, dtype=F64),
                    torch.full((N,), c, dtype=F64))
                   for a, b, c in itertools.product(SPECS["sub_len"], SPECS["mod_var"],
                                                    SPECS["mod_len"])]
        for sub_len, mod_var, mod_len in builds:
            b = ssm.build_modulator_ssm(p.sub_var, sub_len, p.omega, mod_var, mod_len,
                                        kernel1=model.kernel1, kernel2=model.kernel2)
            out.append(_block(b.F, b.LQcLT, disc))
    return out


@pytest.mark.parametrize("disc", ["stationary", "matrix_fraction"])
@pytest.mark.parametrize("corpus", ["music", "speech"])
def test_expm_matches_matrix_exp(corpus, disc):
    """Within ULPS ulp of each matrix's max |exp|, and the gradient of a
    seeded cotangent within 1e-12 of the largest, autograd through both."""
    blocks = _blocks(corpus, disc)
    assert len(blocks) == 9 * len(_trained(corpus)) == 180
    for M in blocks:
        got, ref = ssm.expm(M), torch.linalg.matrix_exp(M)
        scale = ref.abs().amax((-1, -2))
        assert ((got - ref).abs().amax((-1, -2)) / scale).max() <= ULPS * torch.finfo(F64).eps
    G = torch.Generator().manual_seed(0)
    for M in blocks[::9]:  # each model once: autograd is the slow part
        X = M.clone().requires_grad_(True)
        cot = torch.randn(M.shape, generator=G, dtype=F64)
        (g_got,) = torch.autograd.grad(ssm.expm(X), X, cot)
        (g_ref,) = torch.autograd.grad(torch.linalg.matrix_exp(X), X, cot)
        assert (g_got - g_ref).abs().max() <= GRAD_RTOL * g_ref.abs().max()


def test_expm_covers_every_configuration_sixteen_times():
    """The largest 1-norm of F dt (dt = 1) and of the matrix-fraction block
    over every trained model (music, speech, source separation, the speech
    probes), the box corners, and the subbands at omega = pi, times 16,
    stays inside the cover."""
    paths = sorted(glob.glob(os.path.join(ROOT, "results", "trained", "**", "*.npz"),
                             recursive=True))
    worst = 0.0
    for path in paths:
        model, p = load_trained(path, device="cpu", dtype=F64)
        for omega in (p.omega, torch.full_like(p.omega, math.pi)):
            b = ssm.build_modulator_ssm(p.sub_var, p.sub_len, omega, p.mod_var, p.mod_len,
                                        kernel1=model.kernel1, kernel2=model.kernel2)
            for disc in ("stationary", "matrix_fraction"):
                M = _block(b.F, b.LQcLT, disc)
                worst = max(worst, M.abs().sum(-2).amax(-1).max().item())
    for disc in ("stationary", "matrix_fraction"):
        for M in _blocks("speech", disc) + _blocks("music", disc):
            worst = max(worst, M.abs().sum(-2).amax(-1).max().item())
    assert len(paths) == 73 and 4.0 < worst
    assert 16.0 * worst <= ssm.expm_cover(F64)


def test_expm_beyond_its_cover_is_nan_and_refused():
    """A matrix whose 1-norm passes the cover comes out NaN, the others as
    they were; a model discretized past it fails the stationarity check,
    whose message names the cover."""
    rot = torch.tensor([[-0.01, -1.0], [1.0, -0.01]], dtype=F64)
    cover = ssm.expm_cover(F64)
    M = torch.stack([rot, rot * 0.99 * cover / 1.01, rot * 1.01 * cover / 1.01])
    got = ssm.expm(M)
    assert torch.isnan(got[2]).all() and torch.isfinite(got[:2]).all()
    assert torch.equal(got[:2], ssm.expm(M[:2]))
    model = GTNMFModel(D=2, N=1, kernel1="exp", kernel2="matern52")
    p = GTNMFParams(lik=0.01, sub_var=[0.5, 0.5], sub_len=[50.0, 50.0], omega=[0.1, 3.0],
                    mod_var=[2.0], mod_len=[200.0], W=[[0.5], [0.7]]).to(dtype=F64)
    fk.check_stationary(model.build_ssm(p))
    far = model.build_ssm(p, dt=60.0)  # omega dt = 180 passes the cover; 6 does not
    assert torch.isnan(far.A[1]).all() and torch.isfinite(far.A[[0, 2]]).all()
    with pytest.raises(ValueError, match="cover of ops.ssm.expm"):
        fk.check_stationary(far)


# ---------------------------------------------------------------------------
# The deferred stationarity check
# ---------------------------------------------------------------------------


def _fit_case(T=16):
    model = GTNMFModel(D=2, N=1, kernel1="exp", kernel2="matern52", variant="sq",
                       p_cubature=3)
    p = GTNMFParams(lik=1e-2, sub_var=[0.5, 0.5], sub_len=[40.0, 90.0], omega=[0.3, 1.1],
                    mod_var=[2.0], mod_len=[150.0], W=[[0.6], [0.9]]).to(dtype=F64)
    y = torch.randn(T, generator=torch.Generator().manual_seed(3), dtype=F64)
    specs = {"lik": "fixed", "sub_var": "fixed", "omega": "fixed", "sub_len": (20.0, 400.0),
             "mod_var": (1.0, 10.0), "mod_len": (50.0, 800.0), "W": (0.0, 1.5)}
    return model, p, y, specs


def _nonstationary(monkeypatch):
    """``GTNMFModel.build_ssm`` with Q scaled by 1.5; returns its call log."""
    built = []
    build = GTNMFModel.build_ssm

    def scaled(self, params, dt=1.0):
        built.append(len(built))
        s = build(self, params, dt)
        return s._replace(Q=1.5 * s.Q)

    monkeypatch.setattr(GTNMFModel, "build_ssm", scaled)
    return built


def test_fit_defers_a_failed_check_to_its_return(monkeypatch):
    """Every step runs and queues its check; the one read as the fit
    returns raises check_stationary's ValueError, once."""
    model, p, y, specs = _fit_case()
    built = _nonstationary(monkeypatch)
    fk.reset_launches()
    with pytest.raises(ValueError, match="stationary discretization") as raised:
        fit_hyperparams(model, p, y, specs=specs, steps=3, learning_rate=1e-2, device="cpu",
                        ep_itts=1)
    assert built == [0, 1, 2] and fk.check_stationary.deferred == 3
    assert "max gap" in str(raised.value) and "cover" not in str(raised.value)


def test_check_stationary_outside_a_scope_raises_at_once(monkeypatch):
    model, p, _, _ = _fit_case()
    good = model.build_ssm(p)
    _nonstationary(monkeypatch)
    bad = model.build_ssm(p)
    fk.reset_launches()
    fk.check_stationary(good)
    with pytest.raises(ValueError, match="stationary discretization"):
        fk.check_stationary(bad)
    assert fk.check_stationary.deferred == 0
    # inside a scope nothing is read until it closes; a nested scope defers
    # to the outer one, and a scope left by an exception reads nothing
    with pytest.raises(ValueError, match="stationary discretization"):
        with fk.deferred_stationarity():
            with fk.deferred_stationarity():
                fk.check_stationary(bad)
            fk.check_stationary(good)
            assert fk.check_stationary.deferred == 2
    with pytest.raises(KeyError):
        with fk.deferred_stationarity():
            fk.check_stationary(bad)
            raise KeyError("the body's own error")
    assert fk.check_stationary.deferred == 3


def test_fit_counts_one_deferred_check_a_step():
    model, p, y, specs = _fit_case()
    fk.reset_launches()
    fit = fit_hyperparams(model, p, y, specs=specs, steps=3, learning_rate=1e-2, device="cpu",
                          ep_itts=1)
    assert fk.check_stationary.deferred == 3
    assert torch.isfinite(fit.energies).all() and fit.energies.shape == (3,)
    fk.reset_launches()
    fk.check_stationary(model.build_ssm(p))
    assert fk.check_stationary.deferred == 0
