"""The training cell's check fails where it should, and its per-layer
metrics read a hand-written trace.

On the CPU at a small size (the program runs its plain versions; the
harness's look for a chip is skipped by calling ``run_cell`` directly): the
control (the reference in float32 with TF32 products) fails a limit; a
sound run is correct; a gradient with one group scaled by 1.01 where it is
produced fails ``grad``; an Adam step dropped fails ``update``.
"""

import json
import time

import pytest
import torch

from benchmark import run, spans
from benchmark.control import readings
from benchmark.manifest import Manifest
from benchmark.traced import read_chrome_trace

CELL = "train_vg_speech_16k"
SMALL = dict(T=96, steps=3)
SEED = 2**31 + 101


def _run():
    return run.run_cell(Manifest(), CELL, SEED, 0.01, False, "cpu", time.time(), SMALL)


def test_control_fails_a_limit():
    man = Manifest()
    control = readings(man, CELL, SEED, "cpu", SMALL)
    limits = man.limits(CELL)
    assert any(control[k] > v for k, v in limits.items()), (control, limits)


def test_sound_run_is_correct():
    r = _run()
    assert r["correct"], r["checks"]


def test_a_group_gradient_scaled_fails_grad(monkeypatch):
    """K7's cotangent of W times 1.01: the W group's gradient is 1.01 times
    what it should be (W enters the energy only through the sweep)."""
    from nsgp_tpu_torch.ops import fused_kalman

    backward = fused_kalman.FusedADF.backward

    def scaled(ctx, *grads):
        out = list(backward(ctx, *grads))
        out[6] = out[6] * 1.01
        return tuple(out)

    monkeypatch.setattr(fused_kalman.FusedADF, "backward", staticmethod(scaled))
    r = _run()
    assert not r["correct"]
    assert r["checks"]["grad"]["value"] > r["checks"]["grad"]["limit"], r["checks"]
    assert r["checks"]["energy"]["value"] <= r["checks"]["energy"]["limit"], r["checks"]


def test_a_dropped_adam_step_fails_update(monkeypatch):
    """The second of the steps evaluates its closure and updates nothing."""
    step = torch.optim.Adam.step
    seen = []

    def dropped(self, closure=None):
        seen.append(self)
        if sum(s is self for s in seen) == 2:
            with torch.enable_grad():
                return closure()
        return step(self, closure)

    monkeypatch.setattr(torch.optim.Adam, "step", dropped)
    r = _run()
    assert not r["correct"]
    assert r["checks"]["update"]["value"] > r["checks"]["update"]["limit"], r["checks"]


# ---------------------------------------------------------------------------
# The readers on a hand-written trace
# ---------------------------------------------------------------------------
#
# Two calls of one shape, the second 1000 us after the first; per call
# (microseconds from the call's start; the K7 span and its launch on the
# autograd engine's thread, tid 2):
#
#   bench.call [0, 1000]
#     nsgp.fit_hyperparams [5, 995]
#       nsgp.step [10, 990]
#         nsgp.ep_energy [20, 400]
#           nsgp.assemble [20, 100]      launch 1 at 30  -> kernel [40, 60]
#           nsgp.sweep1 [110, 390]
#             nsgp.K3 [120, 140]         launch 2 at 130 -> K3 [150, 380]
#         nsgp.backward [410, 900]       launch 3 at 420 -> kernel [430, 450] (tid 2)
#           nsgp.K7 [500, 520] (tid 2)   launch 4 at 510 -> K7 [600, 850]
#                                        launch 5 at 880 -> kernel [885, 895] (tid 2)
#                                        launch 6 at 950 -> kernel [955, 975] (Adam)
#
# Busy per call: [40, 60], [150, 380], [430, 450], [600, 850], [885, 895],
# [955, 975].  Gaps and their innermost span: [0, 40] (assemble, 40),
# [60, 150] (midpoint 105: ep_energy), [380, 430] (midpoint 405: step, 50),
# [450, 600] (midpoint 525: backward, 150), [850, 885] (backward, 35),
# [895, 955] (midpoint 925: step, 60).  The first call's last gap runs on
# into the second call to its first kernel, [975, 1040] (midpoint 1007.5:
# fit_hyperparams), so assemble gets 40 once; the second call's last gap
# [1975, 2000] (midpoint 1987.5: step, 25) ends the window.

KERNELS = [  # (launch at, tid, kernel start, end, name)
    (30, 1, 40, 60, "elementwise_kernel"),
    (130, 1, 150, 380, "void (anonymous namespace)::fused_adf_kernel<float, 3>()"),
    (420, 2, 430, 450, "reduce_kernel"),
    (510, 2, 600, 850, "void (anonymous namespace)::fused_adf_vjp_kernel<float, 3>()"),
    (880, 2, 885, 895, "gemv2N_kernel"),
    (950, 1, 955, 975, "multi_tensor_apply_kernel"),
]
SPANS = [("nsgp.fit_hyperparams", 5, 995, 1), ("nsgp.step", 10, 990, 1),
         ("nsgp.ep_energy", 20, 400, 1), ("nsgp.assemble", 20, 100, 1),
         ("nsgp.sweep1", 110, 390, 1), ("nsgp.K3", 120, 140, 1), ("nsgp.backward", 410, 900, 1),
         ("nsgp.K7", 500, 520, 2)]


def _x(name, cat, a, b, tid=1, **args):
    ev = {"ph": "X", "cat": cat, "name": name, "ts": a, "dur": b - a, "pid": 1, "tid": tid}
    if args:
        ev["args"] = args
    return ev


def _events(program_spans: bool):
    evs = []
    for call in (0, 1):
        o = 1000 * call
        evs.append(_x("bench.call", "user_annotation", o, o + 1000))
        for i, (at, tid, a, b, name) in enumerate(KERNELS):
            corr = 100 * call + i + 1
            evs.append(_x(name, "kernel", o + a, o + b, tid=7, correlation=corr))
            if program_spans:
                evs.append(_x("cudaLaunchKernel", "cuda_runtime", o + at, o + at + 3, tid=tid,
                              correlation=corr))
        if program_spans:
            evs += [_x(n, "user_annotation", o + a, o + b, tid=t) for n, a, b, t in SPANS]
    return {"traceEvents": evs}


@pytest.fixture
def traced(tmp_path, monkeypatch):
    out = []
    for name, program_spans in (("with", True), ("without", False)):
        (tmp_path / name).mkdir()
        path = tmp_path / name / "trace_cell.json"
        path.write_text(json.dumps(_events(program_spans)))
        tr = read_chrome_trace(path, 2)
        tr.call_s = 1e-3
        out.append(tr)
    monkeypatch.setattr(spans, "TRACE_DIR", tmp_path / "with")
    return out


def test_fit_readers_read_the_numbers_worked_by_hand(traced, tmp_path, monkeypatch):
    man, tr, bare = Manifest(), traced[0], traced[1]
    read = lambda name, t: man.metric(name).read(t)
    assert read("backward_kernels", tr) == 3.0
    assert read("backward_ms", tr) == pytest.approx((20 + 250 + 10) * 1e-3)
    assert read("fit_idle_ms", tr) == pytest.approx((2 * (50 + 150 + 35 + 60) + 25) * 1e-3 / 2)
    assert read("assembly_idle_ms", tr) == pytest.approx(40e-3 / 2)
    # K7's least time: the frozen count over its 250 us a launch
    tr.work = {"K7": (3.35e12 * 1e-6, 0.0, 1)}  # 1 MB: a bound of 1 us
    assert read("k7_roofline", tr) == pytest.approx(100.0 * 1e-6 / 250e-6)
    monkeypatch.setattr(spans, "TRACE_DIR", tmp_path / "without")
    for name in ("backward_kernels", "backward_ms", "fit_idle_ms", "assembly_idle_ms"):
        assert read(name, bare) is None, name
