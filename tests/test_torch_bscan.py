"""Port parity: the blocked parallel-in-time passes, float64 on the CPU.

- ``nsgp_tpu_torch.ops.pscan`` / ``ops.bscan`` (element algebra and blocked
  two-level scans) against ``nsgp_tpu.ops.pscan`` / ``ops.bscan`` on the same
  numpy inputs, at the tolerances ``tests/test_bscan.py`` holds the JAX scans
  to against its sequential engine (filter rtol 1e-8 / atol 1e-9, smoother
  rtol 1e-7 / atol 1e-8): both sides compose the same elements, in another
  order in pass 2 (a loop here, a tree there).
- ``fused_fwd_blocked_plain`` / ``fused_bwd_blocked_plain`` (the three passes
  of the CUDA kernels K1 / K2, step for step) against the sequential
  ``fused_fwd_plain`` / ``fused_bwd_plain`` at 1e-10 of the output's max: the
  two are the same function, composed in another order.

The toy model (D=3, N=2, matern32 subbands in blocks of 4, matern52
modulators of 3 states) has a padded state dim in every modulator block.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsgp_tpu.models.gtnmf import GTNMFModel as JModel
from nsgp_tpu.models.gtnmf import GTNMFParams as JParams
from nsgp_tpu.ops import bscan as jbscan
from nsgp_tpu.ops import kalman as jkalman
from nsgp_tpu.ops import pscan as jpscan
from nsgp_tpu.ops.kalman import Sites as JSites
from nsgp_tpu_torch.convert import load_trained, params_from_numpy
from nsgp_tpu_torch.models.gtnmf import GTNMFModel
from nsgp_tpu_torch.ops import bscan, pscan
from nsgp_tpu_torch.ops import fused_kalman as fk
from nsgp_tpu_torch.ops.kalman import Sites

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAX = os.path.join(ROOT, "results", "trained", "music", "trained_sax_matern32.npz")
D, N = 3, 2


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _toy():
    """The same toy model on both sides, from numpy."""
    rng = np.random.default_rng(0)
    p = dict(lik=np.float64(0.05), sub_var=np.linspace(0.5, 1.5, D),
             sub_len=np.linspace(20.0, 80.0, D), omega=np.linspace(0.1, 1.0, D),
             mod_var=np.full(N, 1.5), mod_len=np.linspace(300.0, 600.0, N),
             W=rng.uniform(0.2, 1.0, (D, N)))
    jm = JModel(D=D, N=N, kernel1="matern32", kernel2="matern52")
    jssm = jm.build_ssm(JParams(**{k: jnp.asarray(v) for k, v in p.items()}))
    ssm = GTNMFModel(*jm).build_ssm(params_from_numpy(p, device="cpu", dtype=torch.float64))
    return jssm, ssm


def _sites(T, C, seed):
    """Random sites with scattered zeros, a run of zero rows and a long gap."""
    rng = np.random.default_rng(seed)
    tt = rng.uniform(0.0, 5.0, (T, C)) * (rng.uniform(size=(T, C)) > 0.2)
    tt[T // 8: T // 8 + 5] = 0.0
    tt[T // 2: T // 2 + T // 4] = 0.0
    return tt, rng.normal(size=(T, C)) * tt


def _kernel_args(ssm, tt, tn, dtype=torch.float64):
    cast = lambda x: torch.as_tensor(x).to(dtype)
    fwd = tuple(map(cast, (tt, tn, ssm.A, ssm.Q, ssm.Pinf, ssm.H)))
    return fwd, cast(torch.diagonal(ssm.pad_eye, dim1=-2, dim2=-1))


def _rel(outs, refs):
    return max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(outs, refs))


# ---------------------------------------------------------------------------
# ops.pscan / ops.bscan against the JAX package
# ---------------------------------------------------------------------------


def test_filter_elements_match_jax():
    jssm, ssm = _toy()
    tt, tn = _sites(40, D + N, 1)
    got = pscan._filter_elements(ssm, Sites(torch.tensor(tt), torch.tensor(tn)))
    want = jpscan._filter_elements(jssm, JSites(jnp.asarray(tt), jnp.asarray(tn)))
    for a, b in zip(got, want):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("which", ["filter", "smoother"])
def test_combines_match_jax(which):
    """Random well-conditioned elements (C and J symmetric PSD) through both
    combines."""
    rng = np.random.default_rng(2)
    bs, shape = 4, (5, 3)

    def psd():
        X = rng.normal(size=shape + (bs, bs))
        return X @ X.swapaxes(-1, -2) / bs

    def elem():
        M, v = rng.normal(size=shape + (bs, bs)), rng.normal(size=shape + (bs,))
        if which == "filter":
            return M, v, psd(), rng.normal(size=shape + (bs,)), psd()
        return M, v, psd()

    ei, ej = elem(), elem()
    t_fn, j_fn = ((pscan._filter_combine, jpscan._filter_combine) if which == "filter"
                  else (pscan._smoother_combine, jpscan._smoother_combine))
    got = t_fn(tuple(map(torch.tensor, ei)), tuple(map(torch.tensor, ej)))
    want = j_fn(tuple(map(jnp.asarray, ei)), tuple(map(jnp.asarray, ej)))
    for a, b in zip(got, want):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("T,chunk", [(64, 16), (200, 32), (250, 64)])
def test_blocked_scans_match_jax(T, chunk):
    jssm, ssm = _toy()
    tt, tn = _sites(T, D + N, 3)
    jsites = JSites(jnp.asarray(tt), jnp.asarray(tn))
    sites = Sites(torch.tensor(tt), torch.tensor(tn))
    ms, Ps = bscan.blocked_filter_with_sites(ssm, sites, chunk)
    jms, jPs = jbscan.blocked_filter_with_sites(jssm, jsites, chunk)
    np.testing.assert_allclose(_np(ms), np.asarray(jms), rtol=1e-8, atol=1e-9)
    np.testing.assert_allclose(_np(Ps), np.asarray(jPs), rtol=1e-8, atol=1e-9)
    # both smoothers from the JAX sequential filter's trajectory
    traj = jkalman.filter_with_sites(jssm, jsites, store=True)
    fms, fPs = np.asarray(traj.ms), np.asarray(traj.Ps)
    sm, sP = bscan.blocked_rts_smoother(ssm, torch.tensor(fms), torch.tensor(fPs), chunk)
    jsm, jsP = jbscan.blocked_rts_smoother(jssm, traj.ms, traj.Ps, chunk)
    np.testing.assert_allclose(_np(sm), np.asarray(jsm), rtol=1e-7, atol=1e-8)
    np.testing.assert_allclose(_np(sP), np.asarray(jsP), rtol=1e-7, atol=1e-8)
    # and the two passes in one call, against the JAX sequential smoother
    both = bscan.blocked_filter_smoother(ssm, sites, chunk)
    seq = jkalman.rts_smoother(jssm, traj)
    for a, b in zip(both, seq):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-7, atol=1e-8)


# ---------------------------------------------------------------------------
# The kernels' own three passes against the sequential plain versions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("T,chunk", [
    (20, 32),  # one chunk: the sequential pass itself
    (32, 32),  # exactly one chunk
    (33, 32),  # a chunk and one step
    (200, 32),  # T not a multiple of the chunk
    (97, 8),  # many short chunks
    (256, 64),  # full chunks only
])
def test_blocked_plain_matches_sequential_plain(T, chunk):
    _, ssm = _toy()
    fwd, pad = _kernel_args(ssm, *_sites(T, D + N, 4))
    ref_f = fk.fused_fwd_plain(*fwd)
    got_f = fk.fused_fwd_blocked_plain(*fwd, chunk=chunk)
    assert _rel(got_f, ref_f) <= 1e-10
    bwd = (*ref_f, fwd[2], fwd[3], pad)
    ref_s = fk.fused_bwd_plain(*bwd)
    got_s = fk.fused_bwd_blocked_plain(*bwd, chunk=chunk)
    assert _rel(got_s, ref_s) <= 1e-10
    if T <= chunk:  # one chunk takes the sequential path: the same bits
        assert all(torch.equal(a, b) for a, b in zip(got_f + got_s, ref_f + ref_s))
    # padded state dims (the fourth of every modulator block) stay exactly zero
    dead = pad > 0
    assert int(dead.sum()) == N
    for m, P in (got_f, got_s):
        assert float(m[:, dead].abs().max()) == 0.0
        assert float((P * (pad[:, :, None] + pad[:, None, :])).abs().max()) == 0.0


def test_blocked_plain_zero_sites_give_pure_prediction():
    """All-zero sites: every chunk's total is the prediction (At = A^L,
    eta = J = 0) and the filter stays at (0, Pinf); the smoother returns it."""
    _, ssm = _toy()
    T, chunk = 70, 16
    fwd, pad = _kernel_args(ssm, np.zeros((T, D + N)), np.zeros((T, D + N)))
    ms, Ps = fk.fused_fwd_blocked_plain(*fwd, chunk=chunk)
    assert float(ms.abs().max()) == 0.0
    assert float((Ps - ssm.Pinf).abs().max()) <= 1e-13 * float(ssm.Pinf.abs().max())
    sm, sP = fk.fused_bwd_blocked_plain(ms, Ps, fwd[2], fwd[3], pad, chunk=chunk)
    assert float(sm.abs().max()) == 0.0
    assert float((sP - ssm.Pinf).abs().max()) <= 1e-12 * float(ssm.Pinf.abs().max())


def test_blocked_plain_propagates_nan():
    """A NaN site shows in K1's outputs from its step on, in its own chunk
    and every later one; a NaN filtered mean in K2's outputs of its own and
    every earlier chunk; the other channels stay finite."""
    _, ssm = _toy()
    T, chunk, at, ch = 100, 16, 37, 1
    tt, tn = _sites(T, D + N, 5)
    tt[at, ch], tn[at, ch] = 1.0, np.nan
    fwd, pad = _kernel_args(ssm, tt, tn)
    ms, _ = fk.fused_fwd_blocked_plain(*fwd, chunk=chunk)
    assert bool(torch.isnan(ms[at:, ch]).all()) and bool(torch.isfinite(ms[:at, ch]).all())
    assert bool(torch.isfinite(ms[:, ch + 1]).all())
    clean = fk.fused_fwd_plain(fwd[0], torch.nan_to_num(fwd[1]), *fwd[2:])
    bad = clean[0].clone()
    bad[at, ch, 0] = float("nan")
    sm, _ = fk.fused_bwd_blocked_plain(bad, clean[1], fwd[2], fwd[3], pad, chunk=chunk)
    assert bool(torch.isnan(sm[: at + 1, ch]).any(dim=-1).all())
    assert bool(torch.isfinite(sm[at + 1:, ch]).all())
    assert bool(torch.isfinite(sm[:, ch + 1]).all())


def test_blocked_plain_float32_on_the_trained_sax_model():
    """float32, T = 4096, chunks of 512, on the trained model whose 1e5-sample
    lengthscale makes Q about 1e-10 of Pinf: the totals of pass 1 multiply up
    512 steps whose covariances are formed by cancellation, so this is where
    float32 totals would show.  1e-4 of the output's max: the sequential
    float32 pass itself sits about 1e-5 from float64 here."""
    model, params = load_trained(SAX, device="cpu", dtype=torch.float64)
    ssm = model.build_ssm(params)
    C = ssm.num_channels
    fwd, pad = _kernel_args(ssm, *_sites(4096, C, 6), dtype=torch.float32)
    ref_f = fk.fused_fwd_plain(*fwd)
    assert _rel(fk.fused_fwd_blocked_plain(*fwd, chunk=512), ref_f) <= 1e-4
    bwd = (*ref_f, fwd[2], fwd[3], pad)
    assert _rel(fk.fused_bwd_blocked_plain(*bwd, chunk=512), fk.fused_bwd_plain(*bwd)) <= 1e-4


@pytest.mark.parametrize("T,C,want", [(1, 1, 32), (33, 19, 32), (4096, 19, 64),
                                      (16000, 57, 128), (53248, 190, 256),
                                      (100000, 19, 256), (53248, 1900, 256),
                                      (10**7, 19, 512)])
def test_chunk_length(T, C, want):
    L = fk.chunk_length(T, C)
    assert L == want and fk.MIN_CHUNK <= L <= fk.MAX_CHUNK and L & (L - 1) == 0
    nc = -(-T // L)
    assert fk.blocked_launch_shape(T, C) == {"chunk": L, "chunks": nc, "threads": nc * C,
                                             "passes": 3 if nc > 1 else 1}


def test_solve_pivoted_matches_lapack_and_pivots():
    rng = np.random.default_rng(7)
    M = torch.tensor(rng.normal(size=(6, 5, 4, 4)))
    M[0, 0, 0, 0] = 0.0  # a zero leading entry: the pivot must come from below
    B = torch.tensor(rng.normal(size=(6, 5, 4, 5)))
    X = fk._solve_pivoted(M, B)
    np.testing.assert_allclose(_np(X), _np(torch.linalg.solve(M, B)), rtol=1e-9, atol=1e-11)
