"""Operations and bytes of the benchmarked kernels, and the card's peaks.

Counted from shapes alone, each input read once and each output written
once; a multiply-add counts as 2.  Frozen copies of the counts that the
port's chip smoke test used for its kernel table, so that a change to a
kernel cannot change its own yardstick.
"""

from __future__ import annotations

# Published peaks of one H100 SXM (NVIDIA's data sheet, 700 W): HBM3 bytes/s
# and float32 FLOP/s outside the tensor cores (the kernels use none).
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS_F32 = 67e12


def filter_flops(bs: int) -> int:
    """One channel, one step: predict (A m, A P, (A P) A' + Q), the
    marginals (H m, P H, H' P H) and the rank-one site update."""
    return 4 * bs**3 + 8 * bs**2 + 6 * bs + 5


def smoother_flops(bs: int) -> int:
    """One channel, one step: predict, Cholesky (bs^3 / 3), the bs
    triangular solve pairs (2 bs^3), G dm and G dP G' (4 bs^3)."""
    return round(10.34 * bs**3) + 8 * bs**2


def sigma_flops(D: int, N: int) -> int:
    """One sigma point, one step: a = W link(x) (2 D N), sqrt / s2e / mean
    and the A1, A2 terms (11 D), x, link and the G1, G2 terms (11 N), the
    log-normaliser and weight (13), and one add per moment row."""
    return 2 * D * N + 11 * D + 11 * N + 13 + (1 + 2 * D + 2 * N)


def bound_ms(n_bytes: float, flops: float) -> float:
    """The least time one H100 could take, in ms."""
    return 1e3 * max(n_bytes / PEAK_BYTES_S, flops / PEAK_FLOPS_F32)


def fwd(T: int, C: int, bs: int, itemsize: int = 4):
    """K1, the fixed-site filter: (bytes, flops)."""
    n = T * C * (2 + bs + bs * bs) + C * (3 * bs * bs + bs)
    return n * itemsize, T * C * filter_flops(bs)


def bwd(T: int, C: int, bs: int, itemsize: int = 4):
    """K2, the RTS smoother: (bytes, flops)."""
    n = 2 * T * C * (bs + bs * bs) + C * (2 * bs * bs + bs)
    return n * itemsize, T * C * smoother_flops(bs)


def adf(T: int, BF: int, D: int, N: int, S: int, bs: int, observed_steps: int,
        itemsize: int = 4):
    """K3 (BF = 1) and K4, the ADF sweep: (bytes, flops).  Only the
    ``observed_steps`` (file, step) pairs run the cubature."""
    C = D + N
    n = T * BF * (2 + 1 + 2 * C + C * (bs + bs * bs)) \
        + BF * (C * (3 * bs * bs + bs) + D * N + 1) + S * (N + 1)
    flops = T * BF * C * filter_flops(bs) + observed_steps * (S * sigma_flops(D, N) + 12 * C)
    return n * itemsize, flops


def resite_flops(D: int, N: int, S: int, observed_steps: int) -> int:
    """One all-T re-site: the cubature at every observed step."""
    return observed_steps * S * sigma_flops(D, N)
