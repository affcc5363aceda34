"""Reduce a profiler trace of a few calls to what the per-layer metrics read.

The traced segment runs after the measured window: ``torch.profiler`` with
CPU and CUDA activity around whole calls, each inside a ``bench.call``
span of the benchmark's own.  Its Chrome trace is read back as device
intervals (kernels, copies, fills) and host spans, on the one clock that
the profiler gives both.
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass, field
from pathlib import Path

from benchmark import counts

CALL_SPAN = "bench.call"

# The port's hand-written kernels by the names of their __global__ functions
# (nsgp_tpu_torch/csrc): what the kernel-level metrics look for.
KERNELS = {
    "K1": ("fwd_totals_kernel", "fwd_carry_kernel", "fwd_emit_kernel"),
    "K2": ("bwd_totals_kernel", "bwd_carry_kernel", "bwd_emit_kernel"),
    "K3": ("fused_adf_kernel",),
    "K4": ("fused_adf_mb_kernel",),
    "K5": ("fused_ihgp_adf_kernel",),
    "K6": ("fused_ihgp_smooth_kernel",),
    "K7": ("fused_adf_vjp_kernel",),
    "K8": ("fused_ihgp_adf_vjp_kernel",),
}
_PATTERNS = {k: re.compile(r"\b(" + "|".join(v) + r")\b") for k, v in KERNELS.items()}
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def kernel_class(name: str):
    """'K1' .. 'K8' for the port's kernels, None for any other."""
    for k, pat in _PATTERNS.items():
        if pat.search(name):
            return k
    return None


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespace and arguments."""
    base = name.split("(")[0]
    base = re.sub(r"<.*", "", base)
    return base.split("::")[-1].replace("void ", "").strip() or name[:80]


@dataclass
class Trace:
    """What the traced segment saw; times in seconds."""

    kernels: list  # (name, start_s, dur_s), device kernels only
    device: list  # (start_s, end_s) of every device interval
    host: list  # (name, start_s, end_s) of host ops and spans
    calls: int
    window: tuple  # (start_s, end_s) of the traced calls
    work: dict = field(default_factory=dict)  # per call, from the job
    call_s: float = 0.0  # median call time of the measured window

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy_intervals(self) -> list:
        """The device's busy time inside the window as merged intervals."""
        lo, hi = self.window
        spans = sorted((max(a, lo), min(b, hi)) for a, b in self.device if b > lo and a < hi)
        merged = []
        for a, b in spans:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def time_of(self, k: str) -> tuple:
        """(seconds, count) of kernel class ``k`` over the segment."""
        hits = [d for n, _, d in self.kernels if kernel_class(n) == k]
        return sum(hits), len(hits)

    def roofline(self, kinds) -> float | None:
        """The kernels' least time at the call's shapes (``counts.bound_ms``
        of their bytes and operations, times their launches) over their
        measured device time, as a share; None where none of them ran."""
        bound = spent = 0.0
        for k in kinds:
            seconds, n = self.time_of(k)
            if k in self.work and n:
                n_bytes, flops, launches = self.work[k]
                bound += counts.bound_ms(n_bytes, flops) * 1e-3 * launches * self.calls
                spent += seconds
        return 100.0 * bound / spent if spent > 0 else None

    def idle_gaps(self, top: int = 10) -> list:
        """The longest idle gaps, each named by the innermost host op or span
        running at its midpoint."""
        busy = self.busy_intervals()
        lo, hi = self.window
        edges = [lo] + [x for a, b in busy for x in (a, b)] + [hi]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for a, b in gaps[:top]:
            mid = 0.5 * (a + b)
            live = [(e - s, n) for n, s, e in self.host if s <= mid <= e]
            out.append([min(live)[1] if live else "(no host op)", b - a])
        return out

    def top_kernels(self, top: int = 10) -> list:
        tot = {}
        for n, _, d in self.kernels:
            key = short_name(n)
            tot[key] = tot.get(key, 0.0) + d
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:top]]


def read_chrome_trace(path: Path, calls: int) -> Trace:
    """Parse ``export_chrome_trace`` output (microseconds) into a Trace."""
    events = json.loads(Path(path).read_text())
    events = events.get("traceEvents", events) if isinstance(events, dict) else events
    kernels, device, host, spans = [], [], [], []
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        s, d = float(ev["ts"]) * 1e-6, float(ev["dur"]) * 1e-6
        cat, name = ev.get("cat", ""), ev.get("name", "")
        if cat in _DEVICE_CATS:
            device.append((s, s + d))
            if cat == "kernel":
                kernels.append((name, s, d))
        elif cat in ("cpu_op", "user_annotation", "python_function"):
            host.append((name, s, s + d))
            if name == CALL_SPAN and cat == "user_annotation":
                spans.append((s, s + d))
    if not spans:
        raise RuntimeError(f"no {CALL_SPAN!r} span in {path}")
    window = (min(a for a, _ in spans), max(b for _, b in spans))
    inside = lambda s: window[0] <= s <= window[1]
    return Trace(kernels=[k for k in kernels if inside(k[1])], device=device, host=host,
                 calls=calls, window=window)
