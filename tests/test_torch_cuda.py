"""The CUDA kernels against their plain versions on the card (marker ``cuda``).

Skipped without a CUDA device.  On a machine with a card, from the
repository root (the port's tests on the card need no jax, so the
repository's conftest, which imports it, is left out):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Every block size class the kernels instantiate is reached through a kernel
pair (bs 2, 3, 4, 6, 8), with both links and variants, a NaN gap, and a
sigma-point count above one round of the CTA's lanes (N=4: 193 ut9 points).
The batched ADF kernel (K4) is held against its plain version at batch width
(several files, masks that differ) and at mixture width (D=48, N=9, 3973
sigma points, a cluster of eight CTAs a file, also with three files), with
K = 129 moment totals, with sigma-point counts just below and above the
cluster threshold and not a multiple of any tile, and K1/K2 at the batched
paths' channel counts (190, 57).  K3 runs 130 channels (D=126, N=4).
The blocked passes of K1/K2 are held against the sequential plain versions at
ragged lengths (one chunk, one step more than a chunk, a short last chunk),
every block size from 1 to 8, one channel and 190, with runs of zero sites and
a long gap, for equal bits over two runs, exactly zero padded dims and NaN
propagation.
Tolerances relative to the reference's max |value|: 1e-9 in float64 (the
two differ in summation order and FMA contraction only), 1e-4 in float32
at these short lengths.
"""

import numpy as np
import pytest
import torch

from nsgp_tpu_torch.models.gtnmf import GTNMFModel, GTNMFParams, sample_prior, stack_params
from nsgp_tpu_torch.ops import fused_kalman as fk

TOL = {torch.float64: 1e-9, torch.float32: 1e-4}
T = 64


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rel(outs, refs):
    worst = 0.0
    for a, b in zip(outs, refs):
        worst = max(worst, ((a - b).abs().max() / b.abs().max().clamp_min(1e-300)).item())
    return worst


def _case(k1, k2, D, N, dtype, dev, link="softplus", variant="amp"):
    rng = np.random.default_rng(0)
    model = GTNMFModel(D=D, N=N, kernel1=k1, kernel2=k2, link=link, variant=variant)
    params = GTNMFParams(
        lik=np.float64(0.05), sub_var=np.linspace(0.5, 1.5, D),
        sub_len=np.linspace(20.0, 80.0, D), omega=np.linspace(0.1, 1.0, D),
        mod_var=np.full(N, 1.5), mod_len=np.linspace(300.0, 600.0, N),
        W=rng.uniform(0.2, 1.0, (D, N)),
    ).to(dtype=dtype, device=dev)
    y, _, _ = sample_prior(torch.Generator().manual_seed(1), model, params, T)
    mask = torch.ones(T, dtype=torch.bool, device=dev)
    mask[20:28] = False
    return model, params, model.build_ssm(params), y, mask


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("k1,k2", [("exp", "exp"), ("exp", "matern52"),
                                   ("matern32", "matern52"), ("matern52", "matern32"),
                                   ("matern72", "exp")])
def test_fwd_bwd_kernels_match_plain(cuda, k1, k2, dtype):
    _, _, ssm, _, _ = _case(k1, k2, 3, 2, dtype, cuda)
    rng = np.random.default_rng(2)
    C = ssm.num_channels
    tt = rng.uniform(0.0, 5.0, (T, C)) * (rng.uniform(size=(T, C)) > 0.2)
    tt, tn = (torch.tensor(x, dtype=dtype, device=cuda) for x in (tt, rng.normal(size=(T, C)) * tt))
    args = (tt, tn, ssm.A, ssm.Q, ssm.Pinf, ssm.H)
    fk.reset_launches()
    out = fk.fused_fwd(*args)
    ref = fk.fused_fwd_plain(*args)
    assert _rel(out, ref) <= TOL[dtype]
    pad = torch.diagonal(ssm.pad_eye, dim1=-2, dim2=-1)
    out = fk.fused_bwd(*ref, ssm.A, ssm.Q, pad)
    assert _rel(out, fk.fused_bwd_plain(*ref, ssm.A, ssm.Q, pad)) <= TOL[dtype]
    torch.cuda.synchronize()
    assert (fk.fused_fwd.launches, fk.fused_bwd.launches) == (1, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("k1,k2,N,link,variant", [
    ("matern32", "matern52", 2, "softplus", "amp"),
    ("matern32", "matern52", 2, "exp", "sq"),
    ("exp", "matern32", 4, "softplus", "sq"),  # 193 sigma points: two tiles
    ("matern52", "exp", 2, "softplus", "amp"),
])
def test_adf_kernel_matches_plain(cuda, k1, k2, N, link, variant, dtype):
    model, params, ssm, y, mask = _case(k1, k2, 3, N, dtype, cuda, link, variant)
    mp = model.moment_params()
    fk.reset_launches()
    out = fk.adf_filter_fused(mp, ssm, params.W, params.lik, y, mask, 0.5)
    wn, xi = fk.sigma_points(mp, dtype, cuda)
    ref = fk.fused_adf_plain(y, mask.to(dtype), ssm.A, ssm.Q, ssm.Pinf, ssm.H, params.W, xi,
                             wn, params.lik, damp=0.5, link=link, variant=variant,
                             z_floor=mp.z_floor)
    got = (out[0], out[1], out[2], out[3].ttau, out[3].tnu)
    assert _rel(got, ref) <= TOL[dtype]
    assert fk.fused_adf.launches == 1
    assert float(out[3].ttau[20:28].abs().max()) == 0.0 and float(out[2][20:28].abs().max()) == 0.0


@pytest.mark.cuda
def test_wrappers_raise_instead_of_falling_back(cuda):
    model, params, ssm, y, mask = _case("matern32", "matern52", 3, 2, torch.float32, cuda)
    tt = torch.zeros((T, ssm.num_channels), device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        fk.fused_fwd(tt, tt, ssm.A.half(), ssm.Q.half(), ssm.Pinf.half(), ssm.H.half())
    with pytest.raises(ValueError, match="block sizes"):
        big = torch.zeros((ssm.num_channels, 9, 9), device=cuda)
        fk.fused_fwd(tt.float(), tt.float(), big, big, big, torch.zeros((ssm.num_channels, 9),
                                                                       device=cuda))
    C, bs = ssm.H.shape
    pad = torch.diagonal(ssm.pad_eye, dim1=-2, dim2=-1)
    with pytest.raises(ValueError, match="Ps has shape"):
        fk.fused_bwd(torch.zeros((T, C, bs), device=cuda),
                     torch.zeros((T, C, bs, bs - 1), device=cuda), ssm.A, ssm.Q, pad)


def _files(BF, D, N, dtype, dev, link="softplus", variant="sq", k1="exp", k2="matern52",
           steps=T):
    """BF files of one structure: per-file hyperparameters, signals from the
    prior, masks that differ per file.  Returns (model, paramsB, yB, maskB)
    with yB, maskB as (T, BF)."""
    model = GTNMFModel(D=D, N=N, kernel1=k1, kernel2=k2, link=link, variant=variant)
    plist, ys, masks = [], [], []
    for b in range(BF):
        rng = np.random.default_rng(b)
        p = GTNMFParams(
            lik=np.float64(0.02 + 0.01 * b), sub_var=np.linspace(0.5, 1.5, D) / D,
            sub_len=np.linspace(20.0, 80.0 + 5 * b, D), omega=np.linspace(0.1, 2.5, D),
            mod_var=np.full(N, 0.5), mod_len=np.linspace(300.0, 600.0, N),
            W=rng.uniform(0.2, 1.0, (D, N)),
        ).to(dtype=dtype, device=dev)
        y, _, _ = sample_prior(torch.Generator().manual_seed(b), model, p, steps)
        mask = torch.ones(steps, dtype=torch.bool, device=dev)
        mask[10 + 3 * b: 18 + 5 * b] = False
        plist.append(p)
        ys.append(y)
        masks.append(mask)
    return model, stack_params(plist), torch.stack(ys, 1), torch.stack(masks, 1)


def _adf_mb_pair(model, pB, yB, maskB, s_chunk):
    ssmB = model.build_ssm_batch(pB)
    mp = model.moment_params()
    dt_, dev = ssmB.A.dtype, ssmB.A.device
    out = fk.adf_filter_fused_mb(mp, ssmB, pB.W, pB.lik, yB, maskB, 0.5, s_chunk)
    wn, xi = fk.sigma_points(mp, dt_, dev)
    ref = fk.fused_adf_mb_plain(yB, maskB.to(dt_), ssmB.A, ssmB.Q, ssmB.Pinf, ssmB.H, pB.W, xi,
                                wn, pB.lik, damp=0.5, link=mp.link, variant=mp.variant,
                                z_floor=mp.z_floor, s_chunk=s_chunk)
    return (out[0], out[1], out[2], out[3].ttau, out[3].tnu), ref


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("BF,D,N,link,variant,k1,k2,s_chunk", [
    (5, 3, 2, "softplus", "amp", "matern32", "matern52", 0),
    (5, 3, 2, "exp", "sq", "exp", "matern52", 7),
    (3, 4, 4, "softplus", "sq", "exp", "matern32", 64),  # 193 points: two tiles, streamed
    (3, 4, 4, "softplus", "sq", "exp", "matern32", 0),  # ... and under one shift
    (2, 60, 4, "softplus", "sq", "exp", "exp", 0),  # K = 129 moment totals
    (1, 48, 9, "softplus", "sq", "exp", "matern52", 256),  # mixture width, 3973 points
    (3, 48, 9, "softplus", "sq", "exp", "matern52", 256),  # ... three clusters of eight CTAs
])
def test_adf_mb_kernel_matches_plain(cuda, BF, D, N, link, variant, k1, k2, s_chunk, dtype):
    steps = (128 if BF == 3 else 24) if N == 9 else T
    model, pB, yB, maskB = _files(BF, D, N, dtype, cuda, link, variant, k1, k2, steps)
    fk.reset_launches()
    got, ref = _adf_mb_pair(model, pB, yB, maskB, s_chunk)
    assert _rel(got, ref) <= TOL[dtype]
    assert fk.fused_adf_mb.launches == 1 and fk.fused_adf.launches == 0
    for b in range(BF):  # masked steps: zero sites, lZ = 0
        gap = slice(10 + 3 * b, 18 + 5 * b)
        assert float(got[3][gap, b].abs().max()) == 0.0 and float(got[2][gap, b].abs().max()) == 0.0
    again, _ = _adf_mb_pair(model, pB, yB, maskB, s_chunk)
    assert all(torch.equal(a, b) for a, b in zip(got, again))  # fixed-order sums


@pytest.mark.cuda
def test_adf_mb_chunked_agrees_with_one_chunk_at_mixture_width(cuda):
    model, pB, yB, maskB = _files(1, 48, 9, torch.float64, cuda, steps=24)
    one, _ = _adf_mb_pair(model, pB, yB, maskB, 0)
    streamed, _ = _adf_mb_pair(model, pB, yB, maskB, 256)
    assert _rel(streamed, one) <= 1e-9


@pytest.mark.cuda
@pytest.mark.parametrize("C_files", [(10, 16, 3), (1, 48, 9)])  # C = 190, 57
def test_fwd_bwd_kernels_at_batched_channel_counts(cuda, C_files):
    BF, D, N = C_files
    model, pB, _, _ = _files(BF, D, N, torch.float64, cuda, k1="matern32")
    from nsgp_tpu_torch.ops.ssm import flatten_files

    flat = flatten_files(model.build_ssm_batch(pB))
    C = flat.num_channels
    assert C == BF * (D + N)
    rng = np.random.default_rng(3)
    tt = rng.uniform(0.0, 5.0, (T, C)) * (rng.uniform(size=(T, C)) > 0.2)
    tt, tn = (torch.tensor(x, device=cuda) for x in (tt, rng.normal(size=(T, C)) * tt))
    args = (tt, tn, flat.A, flat.Q, flat.Pinf, flat.H)
    ref = fk.fused_fwd_plain(*args)
    assert _rel(fk.fused_fwd(*args), ref) <= 1e-9
    pad = torch.diagonal(flat.pad_eye, dim1=-2, dim2=-1)
    assert _rel(fk.fused_bwd(*ref, flat.A, flat.Q, pad),
                fk.fused_bwd_plain(*ref, flat.A, flat.Q, pad)) <= 1e-9


def _random_rule(S, N, dtype, dev, seed=0):
    """S unit sigma points with signed weights that sum to one (a stand-in
    for a cubature rule of any size)."""
    rng = np.random.default_rng(seed)
    wn = np.abs(rng.normal(size=S)) + 0.2
    wn[::7] *= -0.25
    return (torch.tensor(wn / wn.sum(), dtype=dtype, device=dev),
            torch.tensor(rng.normal(size=(S, N)), dtype=dtype, device=dev))


def _adf_mb_rule_pair(model, pB, yB, maskB, wn, xi, z_floor=None):
    ssmB = model.build_ssm_batch(pB)
    mp = model.moment_params()
    dt_ = ssmB.A.dtype
    args = (yB, maskB.to(dt_), ssmB.A, ssmB.Q, ssmB.Pinf, ssmB.H, pB.W, xi, wn, pB.lik)
    kw = dict(damp=0.5, link=mp.link, variant=mp.variant,
              z_floor=mp.z_floor if z_floor is None else z_floor)
    return fk.fused_adf_mb(*args, **kw), fk.fused_adf_mb_plain(*args, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("S", [7, 63, 512, 513, 1025, 4097, 40001])
def test_adf_mb_kernel_any_number_of_sigma_points(cuda, S, dtype):
    """One CTA up to 512 points, a cluster above (2 at 513, 3 at 1025, 8 at
    4097); none of the counts but 512 is a multiple of a round.  At 40 001
    points in float64 a CTA's share no longer fits in shared memory and is
    read from global memory."""
    from nsgp_tpu_torch.ops import _build

    assert _build.library().nsgp_adf_cluster(S) == min(8, -(-S // 512))
    model, pB, yB, maskB = _files(2, 5, 3, dtype, cuda, steps=32)
    wn, xi = _random_rule(S, 3, dtype, cuda)
    got, ref = _adf_mb_rule_pair(model, pB, yB, maskB, wn, xi)
    assert all(bool(torch.isfinite(g).all()) for g in got)
    assert _rel(got, ref) <= TOL[dtype]
    again, _ = _adf_mb_rule_pair(model, pB, yB, maskB, wn, xi)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_adf_mb_kernel_unstaged_sigma_points_at_mixture_width(cuda, dtype):
    """D=48, N=9 (sixteen lanes a point) with 20 011 points: in float64 the
    CTA's 2 560 rows of ten values exceed the staging budget."""
    model, pB, yB, maskB = _files(2, 48, 9, dtype, cuda, steps=8)
    wn, xi = _random_rule(20011, 9, dtype, cuda)
    got, ref = _adf_mb_rule_pair(model, pB, yB, maskB, wn, xi)
    assert all(bool(torch.isfinite(g).all()) for g in got)
    assert _rel(got, ref) <= TOL[dtype]


@pytest.mark.cuda
def test_adf_mb_deep_log_normalisers_stay_off_the_floor(cuda):
    """A residual of many standard deviations puts every log-normaliser
    far below log(FLT_MIN) = -87: lanes, warps and CTAs with no point must
    merge at weight zero, not at shift 0, or every total underflows and Z
    falls to FLT_MIN.  Without a Z floor (z_floor = 0) lZ shows it."""
    model, pB, yB, maskB = _files(1, 5, 3, torch.float32, cuda, steps=8)
    yB = yB + 25.0  # lZ = -113; much larger outliers make the plain sites overflow too
    maskB[1:] = False  # one such sample; the filter then runs on unobserved
    wn, xi = _random_rule(600, 3, torch.float32, cuda)  # two CTAs, ragged rounds
    got, ref = _adf_mb_rule_pair(model, pB, yB, maskB, wn.abs() / wn.abs().sum(), xi,
                                 z_floor=0.0)
    got, ref = [g[:1] for g in got], [r[:1] for r in ref]  # the step of that sample
    assert float(ref[2][0]) < -100.0
    assert [bool(torch.isfinite(r).all()) for r in ref] == [True] * 5
    assert [bool(torch.isfinite(g).all()) for g in got] == [True] * 5
    assert abs(float(got[2][0]) - float(ref[2][0])) <= 1e-4 * abs(float(ref[2][0]))
    assert _rel(got, ref) <= TOL[torch.float32]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_adf_kernel_runs_130_channels(cuda, dtype):
    """D=126, N=4: more channels than the 128 threads the kernel once had,
    which it then left unwritten; now a channel a thread of 256."""
    model, pB, yB, maskB = _files(1, 126, 4, dtype, cuda, k1="exp", k2="exp", steps=6)
    p = pB.select(0)
    ssm = model.build_ssm(p)
    mp = model.moment_params()
    out = fk.adf_filter_fused(mp, ssm, p.W, p.lik, yB[:, 0], maskB[:, 0], 0.5)
    wn, xi = fk.sigma_points(mp, dtype, cuda)
    ref = fk.fused_adf_plain(yB[:, 0], maskB[:, 0].to(dtype), ssm.A, ssm.Q, ssm.Pinf, ssm.H, p.W,
                             xi, wn, p.lik, damp=0.5, link=mp.link, variant=mp.variant,
                             z_floor=mp.z_floor)
    got = (out[0], out[1], out[2], out[3].ttau, out[3].tnu)
    assert all(bool(torch.isfinite(g).all()) for g in got)
    assert _rel(got, ref) <= TOL[dtype]


@pytest.mark.cuda
def test_adf_refuses_what_it_cannot_run(cuda):
    dt_ = torch.float32
    model, params, ssm, y, mask = _case("matern32", "matern52", 3, 2, dt_, cuda)
    wn, xi = fk.sigma_points(model.moment_params(), dt_, cuda)
    args = [y, mask.to(dt_), ssm.A, ssm.Q, ssm.Pinf, ssm.H, params.W, xi, wn, params.lik]
    kw = dict(damp=0.5, link="softplus", variant="amp", z_floor=1e-10)
    for i in (5, 6, 8):  # H, W, wn: a shape that disagrees with the others
        bad = list(args)
        bad[i] = bad[i][..., :-1]
        with pytest.raises(ValueError, match="has shape"):
            fk.fused_adf(*bad, **kw)
    # more subbands than a warp's lanes take, four a lane
    model, pB, yB, maskB = _files(1, 130, 2, dt_, cuda, k1="exp", k2="exp", steps=4)
    p = pB.select(0)
    with pytest.raises(ValueError, match="at most 128 subbands"):
        fk.adf_filter_fused(model.moment_params(), model.build_ssm(p), p.W, p.lik, yB[:, 0],
                            maskB[:, 0], 0.5)


@pytest.mark.cuda
def test_adf_mb_refuses_what_it_cannot_run(cuda):
    # more subbands than a warp's lanes take, four a lane: D = 130 > 128
    model, pB, yB, maskB = _files(1, 130, 2, torch.float32, cuda, k1="exp", k2="exp", steps=4)
    with pytest.raises(ValueError, match="at most 128 subbands"):
        _adf_mb_pair(model, pB, yB, maskB, 0)
    # (the shared layout is a few KB plus the staged sigma points at any
    # accepted width, so no accepted shape exceeds the block's limit any more)
    model, pB, yB, maskB = _files(2, 3, 2, torch.float32, cuda, steps=8)
    ssmB = model.build_ssm_batch(pB)
    wn, xi = fk.sigma_points(model.moment_params(), torch.float32, cuda)
    with pytest.raises(ValueError, match="sn2 has shape"):
        fk.fused_adf_mb(yB, maskB.float(), ssmB.A, ssmB.Q, ssmB.Pinf, ssmB.H, pB.W, xi, wn,
                        pB.lik[:1], damp=0.5, link="softplus", variant="sq", z_floor=1e-10)


# ---------------------------------------------------------------------------
# K1 / K2 as blocked passes: ragged lengths, every block size class
# ---------------------------------------------------------------------------

# (T, chunk): None = the wrapper's own chunk_length (32 at these lengths)
RAGGED = [(1, None), (31, None), (32, None), (33, None), (97, 32), (257, 64), (515, 8)]
BLOCKS = {2: ("exp", "exp"), 3: ("exp", "matern52"), 4: ("matern32", "matern52"),
          6: ("matern52", "matern32"), 8: ("matern72", "exp")}


def _ssm_leaves(bs, dtype, dev, C=None):
    """(A, Q, Pinf, H, pad) of a toy model with block size ``bs``.  No kernel
    pair gives bs = 1, 5 or 7: those are C synthetic stationary channels, a
    damped rotation A = a R with Pinf = p I, so that Q = p (1 - a^2) I."""
    if bs in BLOCKS:
        _, _, ssm, _, _ = _case(*BLOCKS[bs], 3, 2, dtype, dev)
        return ssm.A, ssm.Q, ssm.Pinf, ssm.H, torch.diagonal(ssm.pad_eye, dim1=-2, dim2=-1)
    C = C or 5
    rng = np.random.default_rng(bs)
    R = np.linalg.qr(rng.normal(size=(C, bs, bs)))[0]
    a = np.linspace(0.5, 0.99, C)[:, None, None]
    p = np.linspace(0.5, 2.0, C)[:, None, None]
    eye = np.broadcast_to(np.eye(bs), (C, bs, bs))
    leaves = (a * R, p * (1 - a * a) * eye, p * eye, rng.uniform(0.2, 1.0, (C, bs)),
              np.zeros((C, bs)))
    return tuple(torch.tensor(np.ascontiguousarray(x), dtype=dtype, device=dev) for x in leaves)


def _gappy_sites(steps, C, dtype, dev, seed):
    """Random sites with scattered zeros, a run of zero rows and one long gap
    (a third of the signal)."""
    rng = np.random.default_rng(seed)
    tt = rng.uniform(0.0, 5.0, (steps, C)) * (rng.uniform(size=(steps, C)) > 0.2)
    tt[steps // 8: steps // 8 + 5] = 0.0
    tt[steps // 2: steps // 2 + steps // 3] = 0.0
    tn = rng.normal(size=(steps, C)) * tt
    return (torch.tensor(x, dtype=dtype, device=dev) for x in (tt, tn))


def _blocked_pair(leaves, steps, chunk, dtype, dev, seed=7):
    A, Q, Pinf, H, pad = leaves
    tt, tn = _gappy_sites(steps, H.shape[0], dtype, dev, seed)
    fwd_args = (tt, tn, A, Q, Pinf, H)
    ref_f = fk.fused_fwd_plain(*fwd_args)
    bwd_args = (*ref_f, A, Q, pad)
    ref_s = fk.fused_bwd_plain(*bwd_args)
    runs = [(fk.fused_fwd(*fwd_args, _chunk=chunk), fk.fused_bwd(*bwd_args, _chunk=chunk))
            for _ in range(2)]
    return runs, (ref_f, ref_s)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("steps,chunk", RAGGED)
@pytest.mark.parametrize("bs", [1, 2, 3, 4, 5, 6, 7, 8])
def test_blocked_fwd_bwd_match_sequential_plain(cuda, bs, steps, chunk, dtype):
    leaves = _ssm_leaves(bs, dtype, cuda)
    pad = leaves[4]
    runs, refs = _blocked_pair(leaves, steps, chunk, dtype, cuda)
    for got, ref in zip(runs[0], refs):
        assert all(bool(torch.isfinite(g).all()) for g in got)
        assert _rel(got, ref) <= TOL[dtype]
    for a, b in zip(runs[0], runs[1]):  # fixed chunk order, no atomics
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    dead = pad > 0
    if bool(dead.any()):  # padded state dims stay exactly zero
        for m, P in runs[0]:
            assert float(m[:, dead].abs().max()) == 0.0
            assert float((P * pad[None, :, :, None]).abs().max()) == 0.0
            assert float((P * pad[None, :, None, :]).abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("C", [1, 190])
def test_blocked_fwd_bwd_one_channel_and_batch_width(cuda, C, dtype):
    """T = 4096 (64 chunks of 64) with one channel, and with the corpus
    batch's 190 (warps that straddle chunks, a ragged last block)."""
    if C == 1:
        leaves = _ssm_leaves(1, dtype, cuda, C=1)
    else:
        from nsgp_tpu_torch.ops.ssm import flatten_files

        model, pB, _, _ = _files(10, 16, 3, dtype, cuda, k1="matern32")
        flat = flatten_files(model.build_ssm_batch(pB))
        leaves = (flat.A, flat.Q, flat.Pinf, flat.H,
                  torch.diagonal(flat.pad_eye, dim1=-2, dim2=-1))
    assert leaves[3].shape[0] == C
    assert fk.blocked_launch_shape(4096, C) == {"chunk": 64, "chunks": 64,
                                                "threads": 64 * C, "passes": 3}
    runs, refs = _blocked_pair(leaves, 4096, None, dtype, cuda)
    for got, ref in zip(runs[0], refs):
        assert _rel(got, ref) <= TOL[dtype]
    for a, b in zip(runs[0], runs[1]):
        assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("chunk", [256, 512])
@pytest.mark.parametrize("bs", [3, 4])
def test_blocked_fwd_bwd_at_the_main_paths_chunk_lengths(cuda, bs, chunk, dtype):
    """The chunk lengths the long signals launch with (256 at T = 53 248 and
    100 000, 512 beyond), over five chunks and three steps: a total multiplies
    up the most steps here, which is where float32 has the least room."""
    leaves = _ssm_leaves(bs, dtype, cuda)
    steps = 5 * chunk + 3
    assert fk.blocked_launch_shape(steps, leaves[3].shape[0], chunk)["chunks"] == 6
    runs, refs = _blocked_pair(leaves, steps, chunk, dtype, cuda)
    for got, ref in zip(runs[0], refs):
        assert _rel(got, ref) <= TOL[dtype]
    for a, b in zip(runs[0], runs[1]):
        assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
def test_blocked_passes_propagate_nan(cuda):
    """A NaN site reaches K1's outputs of its own chunk from that step on
    and of every later chunk; a NaN filtered mean reaches K2's outputs of
    its own and every earlier chunk; other channels stay finite."""
    dtype = torch.float64
    A, Q, Pinf, H, pad = _ssm_leaves(4, dtype, cuda)
    steps, at, ch = 200, 70, 1
    tt, tn = _gappy_sites(steps, H.shape[0], dtype, cuda, 11)
    tt[at, ch], tn[at, ch] = 1.0, float("nan")
    ms, Ps = fk.fused_fwd(tt, tn, A, Q, Pinf, H, _chunk=32)
    assert bool(torch.isnan(ms[at:, ch]).all(dim=-1).all())
    assert bool(torch.isfinite(ms[:at, ch]).all()) and bool(torch.isfinite(ms[:, ch + 1]).all())
    clean = fk.fused_fwd(tt, tn.nan_to_num(), A, Q, Pinf, H, _chunk=32)
    bad = clean[0].clone()
    bad[at, ch, 0] = float("nan")
    sm, _ = fk.fused_bwd(bad, clean[1], A, Q, pad, _chunk=32)
    assert bool(torch.isnan(sm[: at + 1, ch]).any(dim=-1).all())
    assert bool(torch.isfinite(sm[at + 1:, ch]).all()) and bool(torch.isfinite(sm[:, ch + 1]).all())


@pytest.mark.cuda
def test_blocked_passes_take_views_off_a_16_byte_boundary(cuda):
    """Rows move as 16-byte vectors: a contiguous view that starts 4 bytes
    into its storage is copied by the wrapper, not handed to the kernel."""
    A, Q, Pinf, H, pad = _ssm_leaves(4, torch.float32, cuda)
    C = H.shape[0]
    tt, tn = _gappy_sites(100, C, torch.float32, cuda, 3)
    ref = fk.fused_fwd(tt, tn, A, Q, Pinf, H)
    off = lambda x: torch.cat([x.new_zeros(1), x.reshape(-1)])[1:].reshape(x.shape)
    assert off(A).data_ptr() % 16 != 0
    got = fk.fused_fwd(off(tt), off(tn), off(A), off(Q), off(Pinf), off(H))
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    sm = fk.fused_bwd(*ref, A, Q, pad)
    got = fk.fused_bwd(off(ref[0]), off(ref[1]), off(A), off(Q), off(pad))
    assert all(torch.equal(a, b) for a, b in zip(got, sm))
