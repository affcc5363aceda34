"""K7 ``fused_adf_vjp`` (the reverse pass of the energy's sweep 1, once a
value and gradient): least time over device time, %."""


def read(tr):
    return tr.roofline(("K7",))
