"""Operations and bytes of the training path's adjoint kernel, K7
``fused_adf_vjp``: a frozen copy of the count the port's chip smoke test
used for its kernel table (``bound_adf_vjp``), on the per-step counts of
``counts.py``, so that a change to the kernel cannot change its own
yardstick.
"""

from __future__ import annotations

from benchmark import counts


def adf_vjp(T: int, D: int, N: int, S: int, bs: int, observed_steps: int,
            cotangent_values: int, itemsize: int = 4):
    """K7: (bytes, flops).  Reads K3's inputs, its filtered ms and Ps and
    ``cotangent_values`` numbers of output cotangents, writes the
    parameters' cotangents; operations three times K3's (re-deriving a step,
    then its reverse, which costs about twice the forward)."""
    C = D + N
    params = C * (3 * bs * bs + bs) + D * N + 1
    n = T * (2 + C * (bs + bs * bs)) + cotangent_values + 2 * params + S * (N + 1)
    flops = 3 * (T * C * counts.filter_flops(bs)
                 + observed_steps * (S * counts.sigma_flops(D, N) + 12 * C))
    return n * itemsize, flops
