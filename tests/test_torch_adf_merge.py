"""The ADF kernels' merge of shifted partial totals, in plain PyTorch.

The CUDA kernels (``csrc/adf_step.cuh``) let every lane keep its share of the
cubature totals under its own running shift and merge the partials once per
step: lanes of a warp, warps of a CTA, CTAs of a cluster.  The formula lives
in ``ops/fused_kalman.py`` as ``shifted_partial`` / ``merge_shifted_partials``
and is tested here on the CPU against the one-shift sums, with seeded numpy
log-normalisers, signed weights (ut9 has negative ones) and (S, K) terms
split into P partitions.  What the kernels' consumers use are the ratios
``tot[k] / tot[0]`` and ``shift + log(tot[0])``, in which the shift cancels;
those must equal the one-shift values to 1e-12 at float64 (rounding of a
different summation order only).
"""

import math

import numpy as np
import pytest
import torch

from nsgp_tpu_torch.ops import fused_kalman as fk
from torch_threads import one_torch_thread  # noqa: F401

S, K = 397, 11


def _inputs(dtype, seed=0, centre=-40.0):
    rng = np.random.default_rng(seed)
    ln = torch.tensor(centre + 6.0 * rng.normal(size=S), dtype=dtype)
    # signed weights that sum to one, as a cubature rule's do
    wn = rng.normal(size=S)
    wn[: S // 2] = np.abs(wn[: S // 2]) + 1.0
    wn = torch.tensor(wn / wn.sum(), dtype=dtype)
    terms = torch.tensor(rng.normal(size=(S, K)), dtype=dtype)
    terms[:, 0] = 1.0  # Z
    return ln, wn, terms


def _one_shift(ln, wn, terms):
    m = ln.max()
    tot = ((wn * torch.exp(ln - m))[:, None] * terms).sum(0)
    return m, tot


def _merged(ln, wn, terms, parts):
    recs = [fk.shifted_partial(ln[idx], wn[idx], terms[idx]) for idx in parts]
    return fk.merge_shifted_partials(torch.stack([r[0] for r in recs]),
                                     torch.stack([r[1] for r in recs]))


def _split(P, interleaved):
    idx = torch.arange(S)
    if interleaved:  # the kernels deal points out round-robin
        return [idx[p::P] for p in range(P)]
    return list(torch.tensor_split(idx, P))


def _assert_same(m, tot, m0, tot0, tol):
    assert torch.allclose(tot[1:] / tot[0], tot0[1:] / tot0[0], rtol=tol, atol=tol)
    # Z is signed here (negative weights): compare its sign and m + log|Z|
    assert float(tot[0]) * float(tot0[0]) > 0
    assert abs(float(m + torch.log(tot[0].abs())) - float(m0 + torch.log(tot0[0].abs()))) \
        <= tol * 50


@pytest.mark.parametrize("interleaved", [False, True])
@pytest.mark.parametrize("P", [1, 2, 8, 33])
def test_merge_equals_one_shift(P, interleaved):
    ln, wn, terms = _inputs(torch.float64)
    m0, tot0 = _one_shift(ln, wn, terms)
    m, tot = _merged(ln, wn, terms, _split(P, interleaved))
    _assert_same(m, tot, m0, tot0, 1e-12)
    assert float(m) == float(m0)  # the merged shift is the global max


@pytest.mark.parametrize("where", ["first", "middle", "last"])
def test_empty_partition_weighs_zero(where):
    ln, wn, terms = _inputs(torch.float64, seed=1)
    parts = _split(4, True)
    empty = torch.zeros(0, dtype=torch.long)
    parts.insert({"first": 0, "middle": 2, "last": 4}[where], empty)
    m0, tot0 = _one_shift(ln, wn, terms)
    m, tot = _merged(ln, wn, terms, parts)
    _assert_same(m, tot, m0, tot0, 1e-12)


@pytest.mark.parametrize("P", [2, 8])
def test_two_level_merge_equals_one_level(P):
    """Warps then CTAs: merging merged records gives the same ratios."""
    ln, wn, terms = _inputs(torch.float64, seed=2)
    m0, tot0 = _one_shift(ln, wn, terms)
    level1 = [_merged(ln, wn, terms, [idx[q::3] for q in range(3)]) for idx in _split(P, True)]
    m, tot = fk.merge_shifted_partials(torch.stack([r[0] for r in level1]),
                                       torch.stack([r[1] for r in level1]))
    _assert_same(m, tot, m0, tot0, 1e-12)


def test_deep_log_norms_do_not_hit_the_floor_in_float32():
    """All log-normalisers near -500: exp(-500) is 0 in float32, so a partial
    with no point that merged with shift 0 would underflow every total."""
    rng = np.random.default_rng(3)
    ln = torch.tensor(-500.0 + rng.normal(size=S), dtype=torch.float32)
    _, wn, terms = _inputs(torch.float32, seed=3)
    wn = wn.abs() / wn.abs().sum()
    parts = _split(5, True) + [torch.zeros(0, dtype=torch.long)]
    m, tot = _merged(ln, wn, terms, parts)
    assert float(tot[0]) > 1e-3  # Z at the shifted scale is of order one
    lZ = float(m + torch.log(tot[0]))
    ref = torch.logsumexp(ln.double() + torch.log(wn.double()), 0)
    assert abs(lZ - float(ref)) < 1e-3
    # what an empty partial merged at shift 0 would give: Z = 0, clamped to tiny
    assert lZ < math.log(torch.finfo(torch.float32).tiny) - 100


def test_all_partitions_empty_or_at_minus_inf_give_zero_totals():
    ln, wn, terms = _inputs(torch.float64, seed=4)
    ln = torch.full_like(ln, -math.inf)
    m, tot = _merged(ln, wn, terms, _split(3, True) + [torch.zeros(0, dtype=torch.long)])
    assert float(m) == 0.0  # not finite -> 0, applied to the merged shift once
    assert bool((tot == 0).all())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_nan_partition_poisons_without_raising(dtype):
    ln, wn, terms = _inputs(dtype, seed=5)
    parts = _split(4, True)
    ln[parts[2]] = float("nan")
    m, tot = _merged(ln, wn, terms, parts)
    assert bool(torch.isnan(tot).all())
    assert math.isfinite(float(m))  # a NaN never wins the max


def test_minus_inf_point_adds_exactly_zero():
    ln, wn, terms = _inputs(torch.float64, seed=6)
    keep = torch.arange(S) != 7
    m0, tot0 = _one_shift(ln[keep], wn[keep], terms[keep])
    ln[7] = -math.inf
    m, tot = _merged(ln, wn, terms, _split(8, True))
    _assert_same(m, tot, m0, tot0, 1e-12)
