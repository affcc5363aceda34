"""The training cell's plain reference (``benchmark/reference_train.py``)
against the port's ``fit_hyperparams`` and against its own central
differences, on the CPU in float64 at a small size with seeded random
hyperparameters (D = 4 exponential x cosine subbands, N = 2 Matern-5/2
modulators, T = 128)."""

import numpy as np
import pytest
import torch

from benchmark import inputs
from benchmark import reference_train as RT
from benchmark.manifest import Manifest
from torch_threads import one_torch_thread  # noqa: F401

D, N, T = 4, 2, 128
SPECS = {"lik": "fixed", "sub_var": "fixed", "sub_len": [100.0, 2000.0], "omega": "fixed",
         "mod_var": [1.0, 10.0], "mod_len": [200.0, 5000.0], "W": [0.0, 1.5]}
TUNED = {g: tuple(v) for g, v in SPECS.items() if v != "fixed"}


def _weights(seed):
    """Hyperparameters inside the ranges of ``SPECS``."""
    rng = np.random.default_rng(seed)
    return {"lik": 1e-3, "sub_var": rng.uniform(0.04, 0.1, D),
            "sub_len": rng.uniform(150.0, 1500.0, D), "omega": np.sort(rng.uniform(0.05, 1.5, D)),
            "mod_var": rng.uniform(1.5, 5.0, N), "mod_len": rng.uniform(250.0, 900.0, N),
            "W": rng.uniform(0.05, 1.0, (D, N))}


def _config():
    w = {k: np.asarray(v).tolist() for k, v in _weights(7).items()}
    return {"name": "small", "dtype": "float64", "weights": {"small": w},
            "model": {"D": D, "N": N, "kernel1": "exp", "kernel2": "matern52",
                      "link": "softplus", "variant": "sq", "p_cubature": 9, "sigma_points": 27,
                      "block_size": 3}}


def test_fit_hyperparams_matches_the_plain_reference():
    """The entry's recorded last-step energy and gradient against the
    reference at the recorded parameters, and its final parameters against
    Adam recomputed from the recorded gradients, all float64."""
    traffic = dict(Manifest().traffic("fit_speech_16k_10steps"), file="small", T=T, steps=3,
                   specs=SPECS)
    job = Manifest().entry("fit_hyperparams").Job(_config(), traffic, 2**31 + 5, "cpu")
    kept = {k: v.detach().cpu() for k, v in job.keep(job.call(1)).items()}
    readings = job.compare(kept, job.reference(1), 1)
    assert max(readings.values()) < 1e-9, readings
    assert kept["grads"].shape == (3, D + 2 * N + D * N)


@pytest.mark.parametrize("seed", [11, 12])
def test_reference_gradient_matches_central_differences(seed):
    model = _config()["model"]
    w = _weights(seed)
    y = inputs.prior_signal(inputs.stream(seed, 0), model, w, 64)
    u = {g: RT.to_unconstrained(w[g], *TUNED[g]) for g in TUNED}
    E, grad = RT.energy_and_grad(u, w, TUNED, model, y, 0.5)
    h = 1e-5
    for g in TUNED:
        fd = np.zeros_like(u[g])
        for i in np.ndindex(u[g].shape):
            up, dn = ({**u, g: u[g].copy()} for _ in range(2))
            up[g][i] += h
            dn[g][i] -= h
            fd[i] = (RT.energy_and_grad(up, w, TUNED, model, y, 0.5)[0]
                     - RT.energy_and_grad(dn, w, TUNED, model, y, 0.5)[0]) / (2 * h)
        scale = np.abs(grad[g]).max()
        assert np.abs(fd - grad[g]).max() < 1e-6 * scale, (g, fd, grad[g])
    assert np.isfinite(E)


def test_adam_is_torch_adam():
    """The reference's float64 Adam takes torch.optim.Adam's steps."""
    rng = np.random.default_rng(0)
    u0, grads = rng.normal(size=5), rng.normal(size=(4, 5))
    p = torch.tensor(u0, requires_grad=True)
    opt = torch.optim.Adam([p], lr=1e-2)
    for g in grads:
        p.grad = torch.tensor(g)
        opt.step()
    np.testing.assert_allclose(RT.adam(u0, grads, 1e-2), p.detach().numpy(), rtol=0,
                               atol=1e-15)
