"""K5 ``fused_ihgp_adf`` (the steady ADF sweep, once a sweep): the sum of
its launches' least times at the call's shapes over their device time, %."""

from benchmark import counts


def read(tr):
    launches = tr.work.get("K5")
    seconds, n = tr.time_of("K5")
    if not launches or not n:
        return None
    bound = sum(counts.bound_ms(b, f) for b, f in launches) * 1e-3 * tr.calls
    return 100.0 * bound / seconds
