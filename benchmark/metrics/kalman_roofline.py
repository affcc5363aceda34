"""K1 ``fused_fwd`` and K2 ``fused_bwd`` together (the fixed-site filter and
the smoother, three CUDA kernels each): the sum of their passes' least
times over the six kernels' device time, %."""


def read(tr):
    return tr.roofline(("K1", "K2"))
