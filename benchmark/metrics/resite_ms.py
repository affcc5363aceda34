"""Device time a call in kernels launched inside the program's re-site
spans (``nsgp.resite``: the moment match and the site update), in ms; None
where the program records no such span."""

from benchmark import spans


def read(tr):
    got = spans.kernels(tr, "resite")
    return None if got is None else 1e3 * got[1]
