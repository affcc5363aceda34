"""K6 ``fused_ihgp_smooth`` (the steady smoother of the sequential form,
once a sweep): least time over device time, %."""


def read(tr):
    return tr.roofline(("K6",))
