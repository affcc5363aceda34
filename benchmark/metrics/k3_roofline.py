"""K3 ``fused_adf`` (sweep 1 of one signal): least time over device time, %."""


def read(tr):
    return tr.roofline(("K3",))
