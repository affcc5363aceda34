"""The frozen operation and byte counts, pinned at the kernel table's shapes."""

import pytest

from benchmark import counts


def test_k3_single_signal():
    n_bytes, flops = counts.adf(100_000, 1, 16, 3, 77, 4, 100_000)
    assert flops / 1e9 == pytest.approx(3.556, abs=5e-4)
    assert counts.bound_ms(n_bytes, flops) == pytest.approx(0.0531, abs=1e-4)


def test_k4_mixture_width():
    n_bytes, flops = counts.adf(16_000, 1, 48, 9, 3973, 3, 16_000)
    assert flops / 1e9 == pytest.approx(103.11, abs=5e-3)
    assert counts.bound_ms(n_bytes, flops) == pytest.approx(1.539, abs=1e-3)


def test_k4_batch_width():
    observed = 349_668 - 60 * 321
    n_bytes, flops = counts.adf(53_248, 10, 16, 3, 77, 4, observed)
    assert n_bytes / 1e6 == pytest.approx(896.7, abs=0.1)
    assert counts.bound_ms(n_bytes, flops) == pytest.approx(0.268, abs=1e-3)


def test_k1_single_signal():
    assert counts.bound_ms(*counts.fwd(100_000, 19, 4)) == pytest.approx(0.0499, abs=1e-4)
    assert counts.bound_ms(*counts.bwd(100_000, 19, 4)) == pytest.approx(0.0907, abs=1e-4)


def test_per_step_counts():
    assert (counts.filter_flops(4), counts.smoother_flops(4), counts.sigma_flops(16, 3)) \
        == (413, 790, 357)
