"""Device idle time a call in gaps whose innermost program span is an
optimiser step (``nsgp.step``: the closure's set-up and Adam's update) or
its backward pass (``nsgp.backward``: autograd's host time), in ms; None
where the program records no step span.  Traced time: the profiler's
per-op overhead lengthens these gaps, in every commit alike."""

from benchmark import fitspans


def read(tr):
    got = fitspans.idle_innermost(tr, ("nsgp.step", "nsgp.backward"))
    return None if got is None else 1e3 * got
