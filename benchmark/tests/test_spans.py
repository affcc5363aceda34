"""The phase metrics on a hand-written Chrome trace (``benchmark/spans.py``).

Two calls of one shape, the second 1000 us after the first; per call
(microseconds, from the call's start):

    bench.call [0, 1000]
      nsgp.ep_infer [10, 990]
        nsgp.assemble [10, 200]        launch 1 at 20   -> kernel [30, 50]
                                       aten::copy_ [100, 150]
        nsgp.sweep1 [210, 500]
          nsgp.check_stationary [210, 260]  launch 2 at 215 -> kernel [220, 230]
          nsgp.K3 [270, 290]           driver launch 3 at 280 -> K3 [285, 480]
        nsgp.resite [510, 700]         launch 4 at 520 -> kernel [530, 560]
                                       launch 5 at 600 -> kernel [610, 620]
        nsgp.pass [710, 940]
          nsgp.check_stationary [710, 730]
          nsgp.K1 [740, 760]           launch 6 at 750 -> K1 [760, 900]
        nsgp.readout [945, 990]        launch 7 at 950 -> kernel [960, 970]

Idle gaps by phase over both calls: assemble 30 + 170 + 170 (the first
call's opening gap, then [50, 220] twice; the gap between the calls has its
midpoint at 1000, inside no phase), check_stationary 2 x 55, resite
2 x (50 + 140), pass 2 x 60, readout 30 (the second call's closing gap).
"""

import json

import pytest

from benchmark import spans
from benchmark.manifest import Manifest
from benchmark.traced import read_chrome_trace

KERNELS = [  # (launch at, cat, kernel start, end, name)
    (20, "cuda_runtime", 30, 50, "elementwise_kernel"),
    (215, "cuda_runtime", 220, 230, "reduce_kernel"),
    (280, "cuda_driver", 285, 480, "void (anonymous namespace)::fused_adf_kernel<float, 4>()"),
    (520, "cuda_runtime", 530, 560, "gemv2N_kernel"),
    (600, "cuda_runtime", 610, 620, "vectorized_elementwise_kernel"),
    (750, "cuda_runtime", 760, 900, "void (anonymous namespace)::fwd_emit_kernel<float, 4>()"),
    (950, "cuda_runtime", 960, 970, "elementwise_kernel"),
]
SPANS = [("nsgp.ep_infer", 10, 990), ("nsgp.assemble", 10, 200), ("nsgp.sweep1", 210, 500),
         ("nsgp.check_stationary", 210, 260), ("nsgp.K3", 270, 290), ("nsgp.resite", 510, 700),
         ("nsgp.pass", 710, 940), ("nsgp.check_stationary", 710, 730), ("nsgp.K1", 740, 760),
         ("nsgp.readout", 945, 990)]


def _x(name, cat, a, b, **args):
    ev = {"ph": "X", "cat": cat, "name": name, "ts": a, "dur": b - a, "pid": 1, "tid": 1}
    if args:
        ev["args"] = args
    return ev


def _events(program_spans: bool):
    """Both calls' events; without the program's spans and launch events
    where ``program_spans`` is False (a program that records none)."""
    evs = []
    for call in (0, 1):
        o = 1000 * call
        evs.append(_x("bench.call", "user_annotation", o, o + 1000))
        evs.append(_x("aten::copy_", "cpu_op", o + 100, o + 150))
        for i, (at, cat, a, b, name) in enumerate(KERNELS):
            corr = 100 * call + i + 1
            evs.append(_x(name, "kernel", o + a, o + b, correlation=corr))
            if program_spans:
                evs.append(_x("cudaLaunchKernel" if cat == "cuda_runtime" else "cuLaunchKernel",
                              cat, o + at, o + at + 3, correlation=corr))
        if program_spans:
            evs += [_x(n, "user_annotation", o + a, o + b) for n, a, b in SPANS]
    return {"traceEvents": evs}


def _write(directory, events):
    directory.mkdir()
    path = directory / "trace_cell.json"
    path.write_text(json.dumps(events))
    return path


@pytest.fixture
def traced(tmp_path, monkeypatch):
    """(Trace with spans, Trace without), read as the harness reads them,
    each from a directory of its own; ``spans`` looks in the first."""
    out = []
    for name, program_spans in (("with", True), ("without", False)):
        tr = read_chrome_trace(_write(tmp_path / name, _events(program_spans)), 2)
        tr.call_s = 1e-3
        out.append(tr)
    monkeypatch.setattr(spans, "TRACE_DIR", tmp_path / "with")
    return out


def test_kernel_and_gap_attribution(traced, tmp_path):
    sp = spans.read_spans(tmp_path / "with" / "trace_cell.json")
    assert sp.window == pytest.approx((0.0, 2e-3))
    phases = [p for p, _ in sp.kernel_phases()]
    assert phases == ["assemble", "check_stationary", "sweep1", "resite", "resite", "pass",
                      "readout"] * 2
    assert sp.phase_at(255e-6) == "check_stationary" and sp.phase_at(505e-6) is None
    assert sp.phase_at(745e-6) == "pass" and sp.phase_at(1000e-6) is None
    by = {}
    for p, g in sp.gap_phases(traced[0].busy_intervals()):
        by[p] = by.get(p, 0.0) + g
    want = {"assemble": 370, "check_stationary": 110, "resite": 380, "pass": 120,
            "readout": 30, None: 160}
    assert by == pytest.approx({k: v * 1e-6 for k, v in want.items()})


def test_each_metric_reads_the_number_worked_by_hand(traced, tmp_path, monkeypatch):
    man, tr, bare = Manifest(), traced[0], traced[1]
    read = lambda name, t: man.metric(name).read(t)
    assert read("resite_kernels", tr) == 2.0
    assert read("resite_ms", tr) == pytest.approx(0.040)  # (30 + 10) us a call
    assert read("assembly_idle_ms", tr) == pytest.approx(0.240)  # (370 + 110) us / 2
    assert read("assembly_idle_ms.batch", tr) == pytest.approx(0.240)
    assert read("readout_idle_ms.batch", tr) == pytest.approx(0.015)  # 30 us / 2
    # a program without the spans: every phase metric is None, none raises
    monkeypatch.setattr(spans, "TRACE_DIR", tmp_path / "without")
    for name in ("resite_kernels", "resite_ms", "assembly_idle_ms", "readout_idle_ms.batch"):
        assert read(name, bare) is None


def test_a_phase_that_launched_nothing_reads_zero(tmp_path, monkeypatch):
    """A phase with its span but no kernel reads 0, not None."""
    evs = _events(True)
    evs["traceEvents"] = [e for e in evs["traceEvents"]
                          if e.get("args", {}).get("correlation") not in (4, 5, 104, 105)]
    tr = read_chrome_trace(_write(tmp_path / "quiet", evs), 2)
    monkeypatch.setattr(spans, "TRACE_DIR", tmp_path / "quiet")
    man = Manifest()
    assert man.metric("resite_kernels").read(tr) == 0.0
    assert man.metric("resite_ms").read(tr) == 0.0


def test_existing_metrics_read_the_same_with_the_program_spans(traced):
    """What the harness had reads the same whether or not the program
    records spans and launch events; only the gaps' names go to the
    innermost span."""
    man, tr, bare = Manifest(), traced[0], traced[1]
    tr.work = bare.work = {}
    for m in man.data["per_layer"]:
        if m["name"].split(".")[0] in ("resite_ms", "resite_kernels", "assembly_idle_ms",
                                       "readout_idle_ms"):
            continue
        assert man.metric(m["name"]).read(tr) == man.metric(m["name"]).read(bare), m["name"]
    assert man.metric("kernels_per_call").read(tr) == 7.0
    assert man.metric("torch_ops_ms").read(tr) == pytest.approx(0.080)
    assert tr.busy_s == bare.busy_s and tr.top_kernels() == bare.top_kernels()
    gaps, bare_gaps = tr.idle_gaps(top=20), bare.idle_gaps(top=20)
    assert [g for _, g in gaps] == [g for _, g in bare_gaps]
    assert {n for n, _ in bare_gaps} <= {"bench.call", "aten::copy_"}
    assert "nsgp.resite" in {n for n, _ in gaps}


def test_the_trace_is_found_by_its_window(traced, tmp_path):
    """Among several traces the one whose calls span the Trace's window;
    none where no file matches."""
    tr = traced[0]
    other = _events(True)
    for e in other["traceEvents"]:
        e["ts"] += 5000
    (tmp_path / "with" / "trace_later.json").write_text(json.dumps(other))
    assert spans.of(tr).window == pytest.approx(tr.window)
    assert spans.of(tr, tmp_path / "nothing") is None
