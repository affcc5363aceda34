"""Kernels a call launched inside the program's re-site spans
(``nsgp.resite``); None where the program records no such span."""

from benchmark import spans


def read(tr):
    got = spans.kernels(tr, "resite")
    return None if got is None else got[0]
