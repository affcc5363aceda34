"""Kernels a call launched inside the program's table spans
(``nsgp.tables``); None where the program records no such span."""

from benchmark import fitspans


def read(tr):
    got = fitspans.kernels_inside(tr, "nsgp.tables")
    return None if got is None else got[0]
