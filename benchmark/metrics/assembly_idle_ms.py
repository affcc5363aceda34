"""Device idle time a call in gaps whose phase is the program's assembly
(``nsgp.assemble``: input placement, the state-space model and its per-file
loop) or its stationarity check (``nsgp.check_stationary``, a device-to-host
sync before K3/K4 and each K1), in ms; None where the program records no
assembly span.  Traced time: the profiler's per-op overhead lengthens these
gaps, in every commit alike."""

from benchmark import spans


def read(tr):
    got = spans.idle_s(tr, ("assemble", "check_stationary"))
    return None if got is None else 1e3 * got
