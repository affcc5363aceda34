"""What decides ``correct`` fails where it should.

The control (the reference computed in float32 with TF32 products, put in
the program's place) fails a limit of every cell.  A run whose timed path is
broken underneath comes out not correct, for each fault a cell can have: a
step that returns its state unchanged, half of the batch left out, an answer
altered where it is produced.  (One chip: no exchange between chips to leave
out.)  Small sizes on the CPU, where the program runs its plain versions;
the harness's look for a chip is skipped by calling ``run_cell`` directly.
"""

import time

import pytest
import torch

from benchmark import run
from benchmark.control import readings
from benchmark.manifest import Manifest
from benchmark.tests.small import OVERRIDES

CELLS = sorted(OVERRIDES)
SEED = 2**31 + 101


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_a_limit(cell):
    man = Manifest()
    control = readings(man, cell, SEED, "cpu", OVERRIDES[cell])
    limits = man.limits(cell)
    assert any(control[k] > v for k, v in limits.items()), (control, limits)


def _run(cell):
    return run.run_cell(Manifest(), cell, SEED, 0.01, False, "cpu", time.time(), OVERRIDES[cell])


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    r = _run(cell)
    assert r["correct"], r["checks"]


def _state_unchanged(fn):
    """ADF that leaves every step's state at the prior: no site, no update."""
    def broken(y, obs, A, Q, Pinf, H, *args, **kw):
        ms, Ps, lZ, tt, tn = fn(y, obs, A, Q, Pinf, H, *args, **kw)
        return (torch.zeros_like(ms), Pinf.expand_as(Ps).clone(), torch.zeros_like(lZ),
                torch.zeros_like(tt), torch.zeros_like(tn))
    return broken


def _answer_altered(factor):
    """The smoother's output altered at one step: its largest state times
    ``factor``."""
    def fault(fn):
        def broken(*args, **kw):
            ms, Ps = fn(*args, **kw)
            ms = ms.clone()
            t = int(ms.abs().flatten(1).amax(1).argmax())
            ms[t] *= factor
            return ms, Ps
        return broken
    fault.__name__ = f"answer_altered_x{factor}"
    return fault


def _half_the_batch(fn):
    """The batch's second half left out: its files get the prior's zeros."""
    from nsgp_tpu_torch.models.gtnmf import GTNMFParams

    def broken(model, paramsB, yB, maskB=None, config=None, device=None):
        h = yB.shape[0] // 2
        half = GTNMFParams(*(x[:h] for x in paramsB.leaves()))
        r = fn(model, half, yB[:h], None if maskB is None else maskB[:h], config, device)
        pad = lambda x, v: torch.cat([x, torch.full((yB.shape[0] - h,) + x.shape[1:], v,
                                                    dtype=x.dtype)])
        return r._replace(Eft=pad(r.Eft, 0.0), Varft=pad(r.Varft, 1.0), nlZ=pad(r.nlZ, 0.0),
                          maxdiff=pad(r.maxdiff, 0.0),
                          sites=type(r.sites)(pad(r.sites.ttau, 0.0), pad(r.sites.tnu, 0.0)))
    return broken


FAULTS = [
    ("ep_piano_100k", "nsgp_tpu_torch.ops.fused_kalman", "fused_adf", _state_unchanged),
    ("ep_piano_100k", "nsgp_tpu_torch.ops.fused_kalman", "fused_bwd", _answer_altered(2.0)),
    ("sep_mix3_16k", "nsgp_tpu_torch.ops.fused_kalman", "fused_adf_mb", _state_unchanged),
    ("sep_mix3_16k", "nsgp_tpu_torch.ops.fused_kalman", "fused_bwd", _answer_altered(1.05)),
    ("gaps_corpus10_53k", "nsgp_tpu_torch.ops.fused_kalman", "fused_adf_mb", _state_unchanged),
    ("gaps_corpus10_53k", "nsgp_tpu_torch.ops.fused_kalman", "fused_bwd",
     _answer_altered(1.05)),
    ("gaps_corpus10_53k", "nsgp_tpu_torch.inference.batched", "ep_infer_batch",
     _half_the_batch),
]


@pytest.mark.parametrize("cell,module,name,fault", FAULTS,
                         ids=[f"{c}-{f.__name__.strip('_')}" for c, _, _, f in FAULTS])
def test_fault_is_not_correct(cell, module, name, fault, monkeypatch):
    import importlib

    mod = importlib.import_module(module)
    monkeypatch.setattr(mod, name, fault(getattr(mod, name)))
    r = _run(cell)
    assert not r["correct"], r["checks"]
