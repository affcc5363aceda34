"""The port's spans and kernel-launch counts, as ``torch.profiler`` sees them.

A span names an entry point (``nsgp.ep_infer``, ``nsgp.ep_energy``,
``nsgp.ihgp_infer``, ``nsgp.ihgp_energy``, ``nsgp.fit_hyperparams``, ...),
a phase of one (``nsgp.assemble``, ``nsgp.sweep1``, ``nsgp.resite``,
``nsgp.pass``, ``nsgp.readout``; in training each optimiser step,
``nsgp.step``, and its ``loss.backward()``, ``nsgp.backward``), a part of a
phase (``nsgp.tables``: IHGP's DARE bank and its steady-state tables, inside
``nsgp.assemble``) or one hand-written kernel's launch (``nsgp.K1`` ..
``nsgp.K9``).  A backward kernel's span (``nsgp.K7``) opens on the autograd
engine's own thread, inside ``nsgp.backward`` in time.  While a profiler
session records, a span is ``torch.profiler.record_function``: it lands in
the same trace as the CUDA kernels, on the profiler's one clock, nested in
the span that caused it.  While none records, a span costs one flag check
and nothing else: no ``record_function``, no dispatcher call, no allocation,
no device sync.  There is no setting; spans are on exactly while a profiler
records.

Span names are constant strings that start with ``nsgp.``; a span never reads
a device value.  Counters are attributes of the function they count, reset by
``fused_kalman.reset_launches``: ``<wrapper>.launches`` through ``launched``,
and ``check_stationary.deferred``, the stationarity checks queued on the
device inside ``fused_kalman.deferred_stationarity``, without a read.
"""

from __future__ import annotations

import functools
from contextlib import contextmanager, nullcontext

import torch.autograd.profiler as _profiler

_OFF = nullcontext()


def span(name: str):
    """A context manager: ``record_function(name)`` while a torch.profiler
    session records, else a shared no-op."""
    if _profiler._is_profiler_enabled:
        return _profiler.record_function(name)
    return _OFF


def spanned(name: str):
    """Decorator: every call of the function inside ``span(name)``."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return call

    return wrap


@contextmanager
def launched(wrapper, name: str):
    """A kernel wrapper's host path up to and including its launch, inside
    ``span(name)``; when it completes, one more ``wrapper.launches``."""
    with span(name):
        yield
    wrapper.launches += 1
