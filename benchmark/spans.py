"""Kernels and idle gaps of a traced segment, attributed to the program's phases.

The program marks each phase of its entry points with a profiler span
(``nsgp.assemble``, ``nsgp.check_stationary``, ``nsgp.sweep1``,
``nsgp.resite``, ``nsgp.pass``, ``nsgp.readout``) nested inside its entry
span, and each hand-written kernel's launch with ``nsgp.K1`` .. ``nsgp.K8``.
This module reads them back from the Chrome trace that the traced segment
wrote (``build/benchmark/trace_<cell>.json``), beside what
``traced.read_chrome_trace`` reads from it:

- a kernel's phase: its correlation id names its launch event
  (``cuda_runtime``, or ``cuda_driver`` for a launch through the driver API);
  the phase is the innermost phase span open on the host at that launch;
- an idle gap's phase: the innermost phase span open at the gap's midpoint,
  the gaps being those between ``Trace.busy_intervals()`` in the window.

A program that records no such span (an older commit) leaves every phase
metric at None.
"""

from __future__ import annotations

import bisect
import functools
import json
from dataclasses import dataclass
from pathlib import Path

from benchmark.traced import CALL_SPAN

PREFIX = "nsgp."
PHASES = ("assemble", "check_stationary", "sweep1", "resite", "pass", "readout")
TRACE_DIR = Path(__file__).resolve().parent.parent / "build" / "benchmark"
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


@dataclass(frozen=True)
class Spans:
    """What the program's spans say about a traced segment; times in seconds."""

    spans: tuple  # (name, start_s, end_s) of every nsgp.* span, by start
    launches: dict  # correlation id -> host time of the launch event
    kernels: tuple  # (name, start_s, dur_s, correlation id) of device kernels
    window: tuple  # (start_s, end_s) of the traced calls

    @functools.cached_property
    def _phases(self) -> tuple:
        return tuple(s for s in self.spans if s[0][len(PREFIX):] in PHASES)

    @functools.cached_property
    def _starts(self) -> list:
        return [s for _, s, _ in self._phases]

    def has(self, phase: str) -> bool:
        """Whether a span of ``phase`` was recorded."""
        return any(n == PREFIX + phase for n, _, _ in self._phases)

    def phase_at(self, t: float):
        """The innermost phase span open at host time ``t`` ('resite', ...),
        None outside every one.  Phase spans nest, so it is the latest
        started one that has not ended."""
        for i in range(bisect.bisect_right(self._starts, t) - 1, -1, -1):
            name, s, e = self._phases[i]
            if s <= t <= e:
                return name[len(PREFIX):]
        return None

    def kernel_phases(self) -> list:
        """(phase or None, dur_s) of each kernel launched inside the window."""
        lo, hi = self.window
        out = []
        for _, _, d, corr in self.kernels:
            t = self.launches.get(corr)
            if t is None:
                out.append((None, d))
            elif lo <= t <= hi:
                out.append((self.phase_at(t), d))
        return out

    def gap_phases(self, busy: list) -> list:
        """(phase or None, seconds) of each idle gap between the merged
        ``busy`` intervals inside the window."""
        lo, hi = self.window
        edges = [lo] + [x for a, b in busy for x in (a, b)] + [hi]
        return [(self.phase_at(0.5 * (a + b)), b - a)
                for a, b in zip(edges[::2], edges[1::2]) if b > a]


def read_spans(path: Path) -> Spans:
    """Parse ``export_chrome_trace`` output (microseconds) into Spans."""
    return _read(str(path), Path(path).stat().st_mtime_ns)


@functools.lru_cache(maxsize=2)
def _read(path: str, _mtime_ns: int) -> Spans:
    events = json.loads(Path(path).read_text())
    events = events.get("traceEvents", events) if isinstance(events, dict) else events
    spans, calls, launches, kernels = [], [], {}, []
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        s, d = float(ev["ts"]) * 1e-6, float(ev["dur"]) * 1e-6
        cat, name, corr = ev.get("cat", ""), ev.get("name", ""), ev.get("args", {}).get(
            "correlation")
        if cat == "user_annotation":
            if name.startswith(PREFIX):
                spans.append((name, s, s + d))
            elif name == CALL_SPAN:
                calls.append((s, s + d))
        elif cat in _LAUNCH_CATS and corr is not None:
            launches.setdefault(corr, s)
        elif cat == "kernel":
            kernels.append((name, s, d, corr))
    if not calls:
        raise RuntimeError(f"no {CALL_SPAN!r} span in {path}")
    window = (min(a for a, _ in calls), max(b for _, b in calls))
    spans.sort(key=lambda x: (x[1], -x[2]))
    return Spans(spans=tuple(spans), launches=launches, kernels=tuple(kernels), window=window)


def of(tr, trace_dir: Path | None = None):
    """The Spans of the Chrome trace that ``tr`` was read from: the newest
    ``trace_*.json`` under ``trace_dir`` whose calls span ``tr.window``;
    None where there is none."""
    paths = sorted(Path(trace_dir or TRACE_DIR).glob("trace_*.json"),
                   key=lambda p: p.stat().st_mtime_ns, reverse=True)
    for path in paths:
        sp = read_spans(path)
        if all(abs(a - b) <= 1e-9 for a, b in zip(sp.window, tr.window)):
            return sp
    return None


def kernels(tr, phase: str):
    """(kernels, device seconds) a call launched in ``phase``; None where
    the trace has no span of that phase."""
    sp = of(tr)
    if sp is None or not sp.has(phase) or tr.calls <= 0:
        return None
    hits = [d for p, d in sp.kernel_phases() if p == phase]
    return len(hits) / tr.calls, sum(hits) / tr.calls


def idle_s(tr, phases) -> float | None:
    """Device idle seconds a call in gaps whose phase is one of ``phases``;
    None where the trace has no span of the first of them."""
    sp = of(tr)
    if sp is None or not sp.has(phases[0]) or tr.calls <= 0:
        return None
    return sum(g for p, g in sp.gap_phases(tr.busy_intervals()) if p in phases) / tr.calls
