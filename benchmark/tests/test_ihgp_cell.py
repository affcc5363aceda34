"""What decides ``correct`` in the infinite-horizon cell fails where it should,
and its work counts are the kernel table's.

The control (the IHGP reference computed in float32 with TF32 products, put
in the program's place) fails a limit.  A run whose timed path is broken
underneath comes out not correct: the smoothed means scaled by 1.01 where
the smoother produces them, every grid lookup shifted by one point, one
table field scaled by 1.001, the re-sites' sites left undamped.  Small
sizes on the CPU, where the program runs its plain versions.
"""

import importlib
import time
from pathlib import Path

import pytest
import torch

from benchmark import counts, counts_ihgp, run
from benchmark.control import readings
from benchmark.manifest import ROOT, Manifest
from benchmark.tests.test_imports import top_level_imports

CELL = "ihgp_piano_100k"
OV = dict(T=3000, inputs=2, n_gaps=4, gap_lengths=[10, 40, 160])
SEED = 2**31 + 101


def _run():
    return run.run_cell(Manifest(), CELL, SEED, 0.01, False, "cpu", time.time(), OV)


def test_control_fails_a_limit():
    control = readings(Manifest(), CELL, SEED, "cpu", OV)
    limits = Manifest().limits(CELL)
    assert any(control[k] > v for k, v in limits.items()), (control, limits)


def test_sound_run_is_correct():
    r = _run()
    assert r["correct"], r["checks"]


def _smoothed_scaled(fn):
    def broken(*args, **kw):
        return fn(*args, **kw) * 1.01
    return broken


def _lookup_shifted(fn):
    def broken(lk, ttau):
        return torch.clamp(fn(lk, ttau) + 1, max=lk.G - 1)
    return broken


def _table_scaled(fn):
    def broken(*args, **kw):
        t = fn(*args, **kw)
        return t._replace(Gn=t.Gn * 1.001)
    return broken


def _undamped(fn):
    def broken(mp, params, cfg, y, mask, mu, var, sites, damp, exclude_last=False):
        return fn(mp, params, cfg, y, mask, mu, var, sites, 1.0, exclude_last)
    return broken


FAULTS = [
    ("nsgp_tpu_torch.ops.fused_ihgp", "fused_ihgp_smooth", _smoothed_scaled),
    ("nsgp_tpu_torch.ops.fused_ihgp", "lookup_idx", _lookup_shifted),
    ("nsgp_tpu_torch.inference.ihgp", "build_tables", _table_scaled),
    ("nsgp_tpu_torch.inference.ihgp", "_resite", _undamped),
]


@pytest.mark.parametrize("module,name,fault", FAULTS,
                         ids=[f.__name__.strip("_") for _, _, f in FAULTS])
def test_fault_is_not_correct(module, name, fault, monkeypatch):
    mod = importlib.import_module(module)
    monkeypatch.setattr(mod, name, fault(getattr(mod, name)))
    r = _run()
    assert not r["correct"], r["checks"]


def test_counts_are_the_kernel_tables():
    """The frozen counts against the chip smoke test's at the cell's shapes:
    K5 matching every step or one, K6 over every (channel, grid point)."""
    import chip_smoke as cs

    T, D, N, S, bs, G = 100_000, 16, 3, 77, 4, 200
    for matched in (T, 1):
        assert counts.bound_ms(*counts_ihgp.ihgp_adf(T, D, N, S, bs, G, matched)) == \
            pytest.approx(cs.bound_ihgp_adf(T, D, N, S, bs, G, matched)[0], rel=1e-12)
    assert counts.bound_ms(*counts_ihgp.ihgp_smooth(T, D + N, bs, (D + N) * G)) == \
        pytest.approx(cs.bound_ihgp_smooth(T, D + N, bs, (D + N) * G)[0], rel=1e-12)


def test_reference_imports_nothing_of_the_program():
    for name in ("reference_ihgp.py", "counts_ihgp.py"):
        assert not top_level_imports(Path(ROOT, "benchmark", name)) & {
            "nsgp_tpu_torch", "nsgp_tpu", "jax", "jaxlib", "flax"}, name
