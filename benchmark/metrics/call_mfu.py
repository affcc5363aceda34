"""The call's operations, counted from its shapes, over the median call time
of the measured window times the card's float32 peak (67 TFLOP/s outside the
tensor cores), %."""

from benchmark import counts


def read(tr):
    flops = tr.work.get("flops")
    if not flops or tr.call_s <= 0:
        return None
    return 100.0 * flops / (tr.call_s * counts.PEAK_FLOPS_F32)
