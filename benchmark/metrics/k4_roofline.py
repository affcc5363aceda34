"""K4 ``fused_adf_mb`` (sweep 1 of a batch, or at cluster width): least
time over device time, %."""


def read(tr):
    return tr.roofline(("K4",))
