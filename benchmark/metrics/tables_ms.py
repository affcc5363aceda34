"""Device time a call in kernels launched inside the program's table spans
(``nsgp.tables``: the IHGP DARE bank, its patching, interpolation and
smoother tables), in ms; None where the program records no such span."""

from benchmark import fitspans


def read(tr):
    got = fitspans.kernels_inside(tr, "nsgp.tables")
    return None if got is None else 1e3 * got[1]
