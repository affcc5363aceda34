"""The infinite-horizon cell's plain reference (``benchmark/reference_ihgp.py``)
against the port's ``ihgp_infer`` and ``build_tables``, on the CPU in
float64: the piano model of configuration ``ihgp_music_m32`` at its widths
(D = 16, N = 3, 77 sigma points, bs = 4), its grid (log10 R from -7 to 4, 32
coarse points, 200 fine), the cell's settings (3 sweeps, damping (0.1,
0.025), the sequential form), T = 512 with one NaN gap.

The two solve the bank by different methods (scipy's Schur solver and an
exact Kronecker Lyapunov solve against the port's doubling), so they agree
to the bank's conditioning, not bit for bit: 1e-9 of each field's largest
value leaves a factor of 20 over the largest gap measured (Gn, 4e-11).
"""

import numpy as np
import pytest
import torch

from benchmark import inputs, job
from benchmark import reference_ihgp as RI
from benchmark.manifest import Manifest
from nsgp_tpu_torch.inference import ihgp
from torch_threads import one_torch_thread  # noqa: F401

T, GAP = 512, slice(200, 260)
TOL = 1e-9


@pytest.fixture(scope="module")
def runs(one_torch_thread):
    man = Manifest()
    cfg = man.config("ihgp_music_m32")
    traffic = man.traffic("ihgp_gaps_100k_3sweeps")
    model, g = cfg["model"], cfg["ihgp"]
    w = job.as_float32(cfg["weights"][traffic["file"]])
    y = inputs.prior_signal(inputs.stream(2**31 + 9, 0), model, w, T)
    obs = np.ones(T, bool)
    obs[GAP] = False
    grid = RI.Grid(g["grid_lo"], g["grid_hi"], g["grid_coarse"], g["grid_fine"])
    kw = dict(ep_itts=traffic["ep_itts"], ep_fraction=traffic["ep_fraction"],
              damping=tuple(traffic["damping"]))
    ref = RI.ihgp(w, model, y, obs, grid=grid, **kw)
    config = ihgp.IHGPConfig(**kw, grid_lo=grid.lo, grid_hi=grid.hi, grid_coarse=grid.coarse,
                             grid_fine=grid.fine, pf_correct=g["pf_correct"],
                             parallel=traffic["parallel"], keep_best=traffic["keep_best"])
    pm = job.program_model(model, model["D"], model["N"])
    params = job.program_params(w, "cpu", torch.float64)
    out = ihgp.ihgp_infer(pm, params, torch.as_tensor(np.where(obs, y, np.nan)), None, config,
                          device="cpu")
    tables = ihgp.build_tables(pm.build_ssm(params), config)
    return ref, out, tables


@pytest.mark.parametrize("field", ["Eft", "Varft", "nlZ"])
def test_posterior_matches_the_reference(runs, field):
    (Eft, Varft, nlZ, _, _), out, _ = runs
    ref = {"Eft": Eft, "Varft": Varft, "nlZ": nlZ}[field]
    got = getattr(out, field)
    assert got.shape == ref.shape
    assert float((got - ref).abs().max() / ref.abs().max()) < TOL


def test_lookups_match_the_reference(runs):
    """The last pass's grid index of every step and channel: the port's is
    the row of its own h'PS h table that each Varft was read from."""
    (_, _, _, idx, _), out, tables = runs
    hit = out.Varft.T[:, :, None] == tables.hPSh[:, None, :]  # (C, T, G)
    assert bool((hit.sum(-1) == 1).all())
    np.testing.assert_array_equal(hit.int().argmax(-1).T.numpy(), idx)


@pytest.mark.parametrize("field", RI.TABLE_FIELDS)
def test_bank_matches_build_tables(runs, field):
    (_, _, _, _, bank), _, tables = runs
    ref = torch.as_tensor(getattr(bank, field))
    got = getattr(tables, field)
    assert got.shape == ref.shape
    assert float((got - ref).abs().max() / ref.abs().max()) < TOL


def test_reference_dares_are_solved(runs):
    (_, _, _, _, bank), _, _ = runs
    assert bank.dare_ok.all()
    assert float(bank.dare_res.max()) < 1e-10
