"""Operations and bytes of the infinite-horizon engine's kernels, K5
``fused_ihgp_adf`` and K6 ``fused_ihgp_smooth``, and of its DARE bank:
frozen copies of the counts the port's chip smoke test used for its kernel
table (``bound_ihgp_adf``, ``bound_ihgp_smooth``), on the per-step counts of
``counts.py``, so that a change to a kernel cannot change its own yardstick.
"""

from __future__ import annotations

from benchmark import counts


def ihgp_adf(T: int, D: int, N: int, S: int, bs: int, G: int, matched_steps: int,
             itemsize: int = 4):
    """K5: (bytes, flops).  Reads y, the match and observed flags, the
    incoming sites (T, C), A, H, the Pinf row, the table rows (C, G, bs + 1),
    W and the sigma points; writes ms (T, C, bs), idx (int32), lZ and the
    sites.  Per step and channel h'A m, A m, the gain and the site
    (2 bs^2 + 4 bs + 16) and two lookups (about 40); per matched step the
    sigma points as K3's."""
    C = D + N
    n = itemsize * (T * (4 + 4 * C + C * bs) + C * (bs * bs + bs + (G + 1) * (bs + 1))
                    + D * N + S * (N + 1) + 5) + 4 * T * C
    flops = T * C * (2 * bs * bs + 4 * bs + 56) \
        + matched_steps * (S * counts.sigma_flops(D, N) + 12 * C)
    return n, flops


def ihgp_smooth(T: int, C: int, bs: int, gain_rows: int, itemsize: int = 4):
    """K6: (bytes, flops).  Reads ms (T, C, bs), idx (int32), A and
    ``gain_rows`` smoother gains (bs, bs); writes the smoothed means.  Per
    step and channel A mf, G (A mf), G m and two adds (6 bs^2 + 2 bs)."""
    n = itemsize * (2 * T * C * bs + C * bs * bs + gain_rows * bs * bs) + 4 * T * C
    return n, T * C * (6 * bs * bs + 2 * bs)


def bank_flops(C: int, coarse: int, bs: int, iterations: int = 30) -> int:
    """The DARE bank's products at every (channel, coarse point): each
    doubling step of the filtering DARE six bs x bs products and two solves
    with bs right-hand sides (an LU of 2 bs^3 / 3 and 2 bs^3 of substitution
    each), each doubling step of the smoother's Lyapunov equation three
    products; the interpolations and the smoother gain are left out, under
    a hundredth of these."""
    dare = 6 * 2 * bs**3 + 2 * (2 * bs**3 // 3 + 2 * bs**3)
    lyap = 3 * 2 * bs**3
    return C * coarse * iterations * (dare + lyap)
