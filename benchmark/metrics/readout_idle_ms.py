"""Device idle time a call in gaps whose phase is the program's read-out
(``nsgp.readout``: the per-file ``reconstruct_signal`` loop and the gap
metrics, or the per-source signals), in ms; None where the program records
no read-out span.  Traced time: the profiler's per-op overhead lengthens
these gaps, in every commit alike."""

from benchmark import spans


def read(tr):
    got = spans.idle_s(tr, ("readout",))
    return None if got is None else 1e3 * got
