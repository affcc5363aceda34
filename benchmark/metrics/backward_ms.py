"""Device time a call in kernels launched inside the program's backward
spans (``nsgp.backward``: K7 and autograd's plain backward through the
assembly and the transforms), in ms; None where the program records no such
span."""

from benchmark import fitspans


def read(tr):
    got = fitspans.kernels_inside(tr, "nsgp.backward")
    return None if got is None else 1e3 * got[1]
