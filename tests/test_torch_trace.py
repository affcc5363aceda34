"""The port's profiler spans and launch counts (``nsgp_tpu_torch/utils/trace.py``).

On the CPU, at tiny sizes: with no profiler recording a span never reaches
``record_function``; under ``torch.profiler`` each benchmarked entry point
gives its entry span with its phases nested in call order, siblings never
overlapping; outputs are bit-identical with and without a profiler;
``launched`` counts as the wrappers' own counters did; ``ihgp_infer`` and
``ihgp_energy`` nest the DARE bank's ``nsgp.tables`` in their assembly.  The
card tests (marker ``cuda``) trace a fused ``ep_infer`` on the card and hold
every kernel to a launch event and a phase, and the ``nsgp.K<n>`` spans to
the wrappers' counters (K9's inside ``nsgp.resite``); ``ihgp_infer``'s K5
and K6 to its sweeps, and its bank to ``nsgp.tables``.  This file imports no JAX; on the card:

    python -m pytest --noconftest -m cuda tests/test_torch_trace.py
"""

import inspect
import json
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.autograd.profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

from nsgp_tpu_torch.apps.missing_data import fill_gaps_batch
from nsgp_tpu_torch.apps.source_sep import separate
from nsgp_tpu_torch.inference.batched import ep_infer_batch
from nsgp_tpu_torch.inference.ep import EPConfig, ep_energy, ep_infer
from nsgp_tpu_torch.inference.ihgp import IHGPConfig, ihgp_energy, ihgp_infer
from nsgp_tpu_torch.inference.learn import fit_hyperparams
from nsgp_tpu_torch.models.gtnmf import GTNMFModel, GTNMFParams, sample_prior, stack_params
from nsgp_tpu_torch.ops import fused_ihgp, fused_kalman
from nsgp_tpu_torch.utils import trace
from torch_threads import one_torch_thread  # noqa: F401

T = 32
PHASES = ("nsgp.assemble", "nsgp.sweep1", "nsgp.resite", "nsgp.pass", "nsgp.readout")


def _params(D, N, seed, dtype=torch.float64, device="cpu"):
    rng = np.random.default_rng(seed)
    return GTNMFParams(
        lik=np.float64(0.05), sub_var=np.linspace(0.5, 1.5, D),
        sub_len=np.linspace(20.0, 80.0, D), omega=np.linspace(0.1, 1.0, D) + 0.05 * seed,
        mod_var=np.full(N, 1.5), mod_len=np.linspace(300.0, 600.0, N),
        W=rng.uniform(0.2, 1.0, (D, N)),
    ).to(dtype=dtype, device=device)


def _signal(model, params, steps, seed):
    cpu = params.on(torch.device("cpu"))
    y, _, _ = sample_prior(torch.Generator().manual_seed(seed), model, cpu, steps)
    return y.to(params.sub_var.device)


MODEL = GTNMFModel(D=2, N=1, kernel1="matern32", kernel2="matern52")


def _calls():
    """Each benchmarked entry point on a tiny input: (call, entry span, the
    spans expected directly under it, those expected under the batched
    engine's span inside it)."""
    p = [_params(2, 1, s) for s in (0, 1)]
    ys = [_signal(MODEL, q, T, 3 + s) for s, q in enumerate(p)]
    pB, yB = stack_params(p), torch.stack(ys)
    mask = torch.ones_like(yB, dtype=torch.bool)
    mask[:, 10:14] = False
    one = ["nsgp.assemble", "nsgp.sweep1", "nsgp.resite", "nsgp.pass"]  # BF = 1
    two = ["nsgp.assemble", "nsgp.sweep1", "nsgp.resite", "nsgp.resite", "nsgp.pass"]
    app = ["nsgp.assemble", "nsgp.ep_infer_batch", "nsgp.readout"]
    kw = dict(backend="fused", ep_itts=2)
    return {
        "ep_infer": (lambda: ep_infer(MODEL, p[0], ys[0], None,
                                      EPConfig(backend="fused", ep_itts=3), device="cpu"),
                     "nsgp.ep_infer", one + ["nsgp.resite", "nsgp.pass"], None),
        "ep_infer_batch": (lambda: ep_infer_batch(MODEL, pB, yB, mask, EPConfig(**kw),
                                                  device="cpu"),
                           "nsgp.ep_infer_batch", two, None),
        "separate": (lambda: separate([MODEL, MODEL], p, ys[0] + ys[1], engine="ep",
                                      n_samples=0, device="cpu", **kw),
                     "nsgp.separate", app, one),
        "fill_gaps_batch": (lambda: fill_gaps_batch(MODEL, pB, yB, mask, engine="ep",
                                                    n_samples=0, device="cpu", **kw),
                            "nsgp.fill_gaps_batch", app, two),
        # the smoother closes the sweep before it; a later sweep's forward
        # pass opens the next
        "ep_energy": (lambda: ep_energy(MODEL, p[0], ys[0], None, EPConfig(ep_itts=3),
                                        device="cpu"),
                      "nsgp.ep_energy", ["nsgp.assemble", "nsgp.sweep1", "nsgp.sweep1",
                                         "nsgp.resite", "nsgp.pass", "nsgp.pass", "nsgp.resite"],
                      None),
        "fit_hyperparams": (lambda: fit_hyperparams(MODEL, p[0], ys[0], specs=FIT_SPECS,
                                                    steps=2, device="cpu"),
                            "nsgp.fit_hyperparams", ["nsgp.step", "nsgp.step"], None),
    }


FIT_SPECS = {"lik": "fixed", "sub_var": "fixed", "omega": "fixed", "mod_var": (1.0, 10.0),
             "W": (0.0, 1.5)}


def _flat(out):
    """Every tensor of a (nested) result, in order."""
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (tuple, list)):
        return [t for x in out for t in _flat(x)]
    return []


def _events(prof, path):
    """The complete events of the profile's Chrome trace."""
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())
    events = events.get("traceEvents", events) if isinstance(events, dict) else events
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


def _spans(events):
    """(name, start, end) of the program's spans, in start order."""
    return sorted(((e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") == "user_annotation" and e["name"].startswith("nsgp.")),
                  key=lambda s: (s[1], -s[2]))


def _children(spans, parent):
    """The spans directly inside ``parent``, in order."""
    inside = [s for s in spans if parent[1] <= s[1] and s[2] <= parent[2] and s != parent]
    return [s for s in inside
            if not any(o[1] <= s[1] and s[2] <= o[2] and o != s for o in inside)]


def test_the_gate_is_the_profiler_flag():
    """The flag ``span`` reads exists and follows a torch.profiler session."""
    assert autograd_profiler._is_profiler_enabled is False
    assert trace.span("nsgp.x") is trace.span("nsgp.y")  # the shared no-op
    with profile(activities=[ProfilerActivity.CPU]):
        assert autograd_profiler._is_profiler_enabled is True
        assert isinstance(trace.span("nsgp.x"), autograd_profiler.record_function)
    assert autograd_profiler._is_profiler_enabled is False


@pytest.mark.parametrize("entry", ["ep_infer", "ep_infer_batch", "separate", "fill_gaps_batch",
                                   "ep_energy"])
def test_entry_point_spans_nest_in_call_order(entry, monkeypatch, tmp_path):
    """No profiler: no ``record_function`` is reached.  Under the profiler:
    one entry span whose phases come in call order, no sibling overlapping
    another; the outputs are the same bits either way."""
    call, top, expected, inner = _calls()[entry]

    def refuse(*a, **k):
        raise AssertionError("record_function reached with no profiler recording")

    with monkeypatch.context() as m:
        m.setattr(autograd_profiler, "record_function", refuse)
        m.setattr(torch.profiler, "record_function", refuse)
        plain = call()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = call()
    for a, b in zip(_flat(plain), _flat(traced), strict=True):
        assert torch.equal(a, b)

    spans = _spans(_events(prof, tmp_path / "trace.json"))
    tops = [s for s in spans if s[0] == top]
    assert len(tops) == 1
    kids = _children(spans, tops[0])
    assert [s[0] for s in kids] == expected
    for a, b in zip(kids, kids[1:]):
        assert a[2] <= b[1], (a, b)
    for batch in (s for s in kids if s[0] == "nsgp.ep_infer_batch"):
        assert [s[0] for s in _children(spans, batch)] == inner
    # the fused passes' stationarity check sits in the sweeps that launch
    checks = [s for s in spans if s[0] == "nsgp.check_stationary"]
    assert checks and all(any(p[0] in ("nsgp.sweep1", "nsgp.pass") and p[1] <= c[1]
                              and c[2] <= p[2] for p in spans) for c in checks)


def test_fit_hyperparams_steps_nest(tmp_path):
    """One entry span holding the steps; each optimiser step holds its
    energy, then its backward pass; the energy at one sweep holds the
    assembly and sweep 1.  The result is the same bits with and without a
    profiler (``torch.optim`` opens spans of its own either way, so the
    no-profiler check of the entry points does not apply)."""
    call, top, expected, _ = _calls()["fit_hyperparams"]
    plain = call()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = call()
    for a, b in zip(_flat(plain), _flat(traced), strict=True):
        assert torch.equal(a, b)
    spans = _spans(_events(prof, tmp_path / "trace.json"))
    (entry,) = [s for s in spans if s[0] == top]
    assert [s[0] for s in _children(spans, entry)] == expected
    steps = [s for s in spans if s[0] == "nsgp.step"]
    assert len(steps) == 2
    for st in steps:
        kids = _children(spans, st)
        assert [s[0] for s in kids] == ["nsgp.ep_energy", "nsgp.backward"]
        assert [s[0] for s in _children(spans, kids[0])] == ["nsgp.assemble", "nsgp.sweep1"]


IHGP_CFG = IHGPConfig(ep_itts=3, ep_fraction=0.75, damping=(0.1, 0.025), grid_lo=-7.0)


def _ihgp_calls():
    """The infinite-horizon entry points on a tiny signal with a gap: (call,
    entry span, the spans directly under it)."""
    p = _params(2, 1, 0)
    y = _signal(MODEL, p, T, 3)
    y[10:14] = float("nan")
    return {
        "ihgp_infer": (lambda: ihgp_infer(MODEL, p, y, None, IHGP_CFG, device="cpu"),
                       "nsgp.ihgp_infer", ["nsgp.assemble", "nsgp.sweep1", "nsgp.resite",
                                           "nsgp.pass", "nsgp.resite", "nsgp.pass"]),
        "ihgp_energy": (lambda: ihgp_energy(MODEL, p, y, None, IHGP_CFG, device="cpu"),
                        "nsgp.ihgp_energy", ["nsgp.assemble", "nsgp.sweep1"]),
    }


@pytest.mark.parametrize("entry", ["ihgp_infer", "ihgp_energy"])
def test_ihgp_spans_nest_in_call_order(entry, monkeypatch, tmp_path):
    """No profiler: no ``record_function`` is reached.  Under the profiler:
    the entry span holds the assembly, which holds the DARE bank's
    ``nsgp.tables``, then the sweeps and re-sites in call order, no sibling
    overlapping another; the outputs are the same bits either way."""
    call, top, expected = _ihgp_calls()[entry]

    def refuse(*a, **k):
        raise AssertionError("record_function reached with no profiler recording")

    with monkeypatch.context() as m:
        m.setattr(autograd_profiler, "record_function", refuse)
        m.setattr(torch.profiler, "record_function", refuse)
        plain = call()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = call()
    for a, b in zip(_flat(plain), _flat(traced), strict=True):
        assert torch.equal(a, b)
    spans = _spans(_events(prof, tmp_path / "trace.json"))
    (entry_span,) = [s for s in spans if s[0] == top]
    kids = _children(spans, entry_span)
    assert [s[0] for s in kids] == expected
    for a, b in zip(kids, kids[1:]):
        assert a[2] <= b[1], (a, b)
    assert [s[0] for s in _children(spans, kids[0])] == ["nsgp.tables"]


class _Wrapper:
    launches = 0


def test_launched_counts_as_the_wrappers_did(tmp_path):
    """One count a completed launch, none for one that raises; the span
    ``nsgp.K<n>`` is there only under a profiler."""
    w = _Wrapper()
    with trace.launched(w, "nsgp.K1"):
        pass
    assert w.launches == 1
    with pytest.raises(RuntimeError), trace.launched(w, "nsgp.K1"):
        raise RuntimeError("launch failed")
    assert w.launches == 1
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.launched(w, "nsgp.K4"):
            pass
    assert w.launches == 2
    assert [s[0] for s in _spans(_events(prof, tmp_path / "trace.json"))] == ["nsgp.K4"]
    # every wrapper counts through ``launched`` under its own span; the plain
    # twins (CPU tensors) count nothing, as before
    names = {"fused_fwd": "K1", "fused_bwd": "K2", "fused_adf": "K3", "fused_adf_mb": "K4",
             "fused_ihgp_adf": "K5", "fused_ihgp_smooth": "K6", "fused_adf_vjp": "K7",
             "fused_ihgp_adf_vjp": "K8", "fused_resite": "K9"}
    wrappers = fused_kalman.WRAPPERS + fused_ihgp.WRAPPERS
    assert sorted(fn.__name__ for fn in wrappers) == sorted(names)
    for fn in wrappers:
        src = inspect.getsource(fn)
        assert f'with launched({fn.__name__}, "nsgp.{names[fn.__name__]}"):' in src
        assert ".launches +=" not in src
    for mod in (fused_kalman, fused_ihgp):
        mod.reset_launches()
    _calls()["ep_infer"][0]()
    assert all(fn.launches == 0 for fn in wrappers)


def test_trace_is_the_only_module_that_records():
    root = Path(trace.__file__).resolve().parents[1]
    users = sorted(str(p.relative_to(root)) for p in root.rglob("*.py")
                   if "record_function" in p.read_text())
    assert users == ["utils/trace.py"]


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from nsgp_tpu_torch.ops import _build

    _build.library()
    return torch.device("cuda")


@pytest.mark.cuda
def test_traced_ep_infer_on_the_card(cuda, tmp_path):
    """A fused ``ep_infer`` at T = 4096 under the profiler: every kernel has
    a launch event (by correlation id) and a phase; each wrapper's ``nsgp.K<n>``
    spans number its launches and hold their launch events, on one clock."""
    model = GTNMFModel(D=4, N=2, kernel1="matern32", kernel2="matern52")
    params = _params(4, 2, 0, torch.float32, cuda)
    y = _signal(model, params, 4096, 5)
    cfg = EPConfig(backend="fused", ep_itts=3)
    ep_infer(model, params, y, None, cfg, device=cuda)  # warm-up
    torch.cuda.synchronize()
    for mod in (fused_kalman, fused_ihgp):
        mod.reset_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ep_infer(model, params, y, None, cfg, device=cuda)
        torch.cuda.synchronize()
    xs = _events(prof, tmp_path / "trace.json")
    spans = _spans(xs)
    launches = {e["args"]["correlation"]: e["ts"] for e in xs
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    kernels = [e for e in xs if e.get("cat") == "kernel"]
    assert kernels
    phase_of = lambda t: [s[0] for s in spans if s[0] in PHASES + ("nsgp.check_stationary",)
                          and s[1] <= t <= s[2]]
    for k in kernels:
        corr = k["args"]["correlation"]
        assert corr in launches, k["name"]
        assert phase_of(launches[corr]), k["name"]
    wrappers = {"nsgp.K1": (fused_kalman.fused_fwd, "fwd_"), "nsgp.K2": (fused_kalman.fused_bwd,
                                                                        "bwd_"),
                "nsgp.K3": (fused_kalman.fused_adf, "fused_adf_kernel"),
                "nsgp.K9": (fused_kalman.fused_resite, "fused_resite_kernel")}
    assert [fn.launches for fn, _ in wrappers.values()] == [2, 3, 1, 2]
    for name, (fn, stem) in wrappers.items():
        ks = [s for s in spans if s[0] == name]
        assert len(ks) == fn.launches, name
        # the launch of each of its kernels lies inside one of its spans
        own = [k for k in kernels if stem in k["name"]]
        assert own, name
        for k in own:
            assert any(s[1] <= launches[k["args"]["correlation"]] <= s[2] for s in ks), name
    # the re-site's kernel launches inside the re-site's phase
    resites = [s for s in spans if s[0] == "nsgp.resite"]
    for k9 in (s for s in spans if s[0] == "nsgp.K9"):
        assert any(r[1] <= k9[1] and k9[2] <= r[2] for r in resites), k9


@pytest.mark.cuda
def test_traced_ihgp_infer_on_the_card(cuda, tmp_path):
    """``ihgp_infer`` at the benchmark cell's model and settings (the piano
    model of ``ihgp_music_m32``, sequential form, 3 sweeps) at T = 4096
    under the profiler: K5 and K6 launch once a sweep, each kernel's launch
    inside its ``nsgp.K5`` / ``nsgp.K6`` span, each of those inside
    ``nsgp.sweep1`` or ``nsgp.pass``, and the spans number the wrappers'
    counts; the DARE bank's kernels launch inside ``nsgp.tables``."""
    from benchmark import inputs, job
    from benchmark.manifest import Manifest

    man = Manifest()
    cfg = man.config("ihgp_music_m32")
    m, g = cfg["model"], cfg["ihgp"]
    w = job.as_float32(cfg["weights"]["piano"])
    model = job.program_model(m, m["D"], m["N"])
    params = job.program_params(w, cuda, torch.float32)
    y = inputs.prior_signal(inputs.stream(5, 0), m, w, 4096)
    y[1000:1320] = np.nan
    y = torch.as_tensor(y, dtype=torch.float32, device=cuda)
    config = IHGPConfig(ep_itts=3, ep_fraction=0.75, damping=(0.1, 0.025),
                        grid_lo=g["grid_lo"], grid_hi=g["grid_hi"],
                        grid_coarse=g["grid_coarse"], grid_fine=g["grid_fine"])
    ihgp_infer(model, params, y, None, config, device=cuda)  # warm-up
    torch.cuda.synchronize()
    fused_ihgp.reset_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ihgp_infer(model, params, y, None, config, device=cuda)
        torch.cuda.synchronize()
    assert (fused_ihgp.fused_ihgp_adf.launches, fused_ihgp.fused_ihgp_smooth.launches) == (3, 3)
    xs = _events(prof, tmp_path / "trace.json")
    spans = _spans(xs)
    within = lambda inner, outer: outer[1] <= inner[1] and inner[2] <= outer[2]
    named = lambda n: [s for s in spans if s[0] == n]
    sweeps = named("nsgp.sweep1") + named("nsgp.pass")
    assert (len(named("nsgp.sweep1")), len(named("nsgp.pass"))) == (1, 2)
    launches = {e["args"]["correlation"]: e["ts"] for e in xs
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    for name, fn, stem in (("nsgp.K5", fused_ihgp.fused_ihgp_adf, "fused_ihgp_adf_kernel"),
                           ("nsgp.K6", fused_ihgp.fused_ihgp_smooth, "fused_ihgp_smooth_kernel")):
        ks = named(name)
        assert len(ks) == fn.launches, name
        assert all(sum(within(k, s) for s in sweeps) == 1 for k in ks), name
        own = [e for e in xs if e.get("cat") == "kernel" and stem in e["name"]]
        assert len(own) == fn.launches, stem
        for k in own:
            t = launches[k["args"]["correlation"]]
            assert any(s[1] <= t <= s[2] for s in ks), stem
    (tables,) = named("nsgp.tables")
    in_tables = [e for e in xs if e.get("cat") == "kernel"
                 and tables[1] <= launches.get(e["args"]["correlation"], -1) <= tables[2]]
    assert in_tables


@pytest.mark.cuda
def test_traced_fit_hyperparams_on_the_card(cuda, tmp_path):
    """``fit_hyperparams`` at T = 2048 under the profiler: its steps hold
    their backward passes, which hold K7's launch spans (opened on the
    autograd engine's thread, so nested by time), and its energies hold
    sweep 1, which holds K3's; K3 launches one kernel a step, K7 two (its
    pre-pass and its reverse walk), each kernel inside its own span."""
    model = GTNMFModel(D=4, N=2, kernel1="exp", kernel2="matern52", variant="sq")
    params = _params(4, 2, 0, torch.float32, cuda)
    y = _signal(model, params, 2048, 5)
    steps = 3
    fit = lambda: fit_hyperparams(model, params, y, specs=FIT_SPECS, steps=steps, device=cuda)
    fit()  # warm-up
    torch.cuda.synchronize()
    fused_kalman.reset_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fit()
        torch.cuda.synchronize()
    assert fused_kalman.fused_adf_vjp.launches == steps
    assert fused_kalman.fused_adf.launches == steps
    xs = _events(prof, tmp_path / "trace.json")
    spans = _spans(xs)
    within = lambda inner, outer: outer[1] <= inner[1] and inner[2] <= outer[2]
    named = lambda n: [s for s in spans if s[0] == n]
    (top,) = named("nsgp.fit_hyperparams")
    chain = ("nsgp.step", "nsgp.backward", "nsgp.K7")
    assert [len(named(n)) for n in chain] == [steps] * 3
    assert all(within(s, top) for s in named("nsgp.step"))
    for inner, outer in (("nsgp.backward", "nsgp.step"), ("nsgp.K7", "nsgp.backward"),
                         ("nsgp.ep_energy", "nsgp.step"), ("nsgp.sweep1", "nsgp.ep_energy"),
                         ("nsgp.K3", "nsgp.sweep1")):
        for s in named(inner):
            assert sum(within(s, o) for o in named(outer)) == 1, (inner, outer, s)
    launches = {e["args"]["correlation"]: e["ts"] for e in xs
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    for stem, name, per_step in (("fused_adf_vjp_kernel", "nsgp.K7", 2),
                                 ("fused_adf_kernel", "nsgp.K3", 1)):
        own = [e for e in xs if e.get("cat") == "kernel" and stem in e["name"]]
        assert len(own) == per_step * steps, stem
        if per_step == 2:  # one pre-pass and one walk a step
            parts = sorted(e["name"].split(stem)[1].split(">")[0].rsplit(",", 1)[1].strip()
                           for e in own)
            assert parts == ["0"] * steps + ["1"] * steps, parts
        for k in own:
            t = launches[k["args"]["correlation"]]
            assert any(s[1] <= t <= s[2] for s in named(name)), stem
