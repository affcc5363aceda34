"""Share of a call in which the device ran nothing, %: one minus the device's
busy time a traced call over the median call time of the untraced window
(the profiler's own host overhead lengthens the traced calls, not this)."""


def read(tr):
    if tr.calls <= 0 or tr.call_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.calls / tr.call_s)
