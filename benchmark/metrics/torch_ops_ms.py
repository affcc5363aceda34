"""Device time a call in kernels that are not the port's K1 to K8: the
plain-torch assembly, re-site and read-out, in ms."""

from benchmark.traced import kernel_class


def read(tr):
    rest = [d for n, _, d in tr.kernels if kernel_class(n) is None]
    return 1e3 * sum(rest) / tr.calls if rest else None
