"""The training path's spans in a traced segment: which kernels a call
launched inside a span of a given name, and which idle gaps lie in a span
that is the innermost of the program's spans there.

``fit_hyperparams`` marks each optimiser step (``nsgp.step``) and its
backward pass (``nsgp.backward``); the autograd engine launches the backward
kernels from a thread of its own, so a launch belongs to a span by host time
alone, not by thread.  Reads the ``spans.Spans`` of the traced segment; a
program that records no such span (an older commit) leaves every metric at
None.
"""

from __future__ import annotations

import bisect

from benchmark import spans as S


def _merged(sp, name: str) -> list:
    """The intervals of every span called ``name``, merged."""
    out = []
    for n, a, b in sp.spans:  # by start
        if n != name:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _inside(intervals: list, t: float) -> bool:
    i = bisect.bisect_right([a for a, _ in intervals], t) - 1
    return i >= 0 and t <= intervals[i][1]


def innermost(sp, t: float):
    """The name of the latest started ``nsgp.*`` span open at host time
    ``t``, None outside every one."""
    starts = [a for _, a, _ in sp.spans]
    for i in range(bisect.bisect_right(starts, t) - 1, -1, -1):
        name, a, b = sp.spans[i]
        if a <= t <= b:
            return name
    return None


def kernels_inside(tr, name: str):
    """(kernels, device seconds) a call launched inside a span ``name``, at
    any depth; None where the trace has no such span."""
    sp = S.of(tr)
    if sp is None or tr.calls <= 0:
        return None
    within = _merged(sp, name)
    if not within:
        return None
    lo, hi = sp.window
    hits = [d for _, _, d, corr in sp.kernels
            if (t := sp.launches.get(corr)) is not None and lo <= t <= hi and _inside(within, t)]
    return len(hits) / tr.calls, sum(hits) / tr.calls


def idle_innermost(tr, names) -> float | None:
    """Device idle seconds a call in gaps whose innermost span at their
    midpoint is one of ``names``; None where the trace has no span of the
    first of them."""
    sp = S.of(tr)
    if sp is None or tr.calls <= 0 or not any(n == names[0] for n, _, _ in sp.spans):
        return None
    lo, hi = sp.window
    busy = tr.busy_intervals()
    edges = [lo] + [x for a, b in busy for x in (a, b)] + [hi]
    return sum(b - a for a, b in zip(edges[::2], edges[1::2])
               if b > a and innermost(sp, 0.5 * (a + b)) in names) / tr.calls
