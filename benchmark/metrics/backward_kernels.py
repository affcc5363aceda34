"""Kernels a call launched inside the program's backward spans
(``nsgp.backward``); None where the program records no such span."""

from benchmark import fitspans


def read(tr):
    got = fitspans.kernels_inside(tr, "nsgp.backward")
    return None if got is None else got[0]
