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
K7, the reverse of K3's sweep (the backward of ``FusedADF``), is held
against its plain twin with seeded cotangents on all five outputs and on lZ
alone, at bs 1-4, at 77, 193 and 3973 sigma points (one CTA walking them in
rounds), through its per-point record and, at 3973 points and under a byte
budget of 0, without it, with a gap and an outlier under the Z floor, for
equal bits over two runs, and for its refusals.
IHGP's two sequential passes, K5 (the steady ADF sweep, K3's moment match
under a table lookup) and K6 (the steady smoother), are held against their
plain twins with a NaN gap, fixed non-zero sites on unobserved steps, sites
at exactly 0, 'sq' and 'exp', at mixture width (a cluster of eight CTAs)
and, for K6, at every block size and at lengths around its block of steps.
K9, the all-T EP re-site, is held against its plain twin (the CPU's
re-site, recomputed in its backward) in float64 at 1e-11 at 77 and 3973
sigma points (one ill-conditioned site at 5e-9), both
links and variants, a masked run, ``exclude_last``, ``use_pep_const``, a
channel whose cavity variance is not positive and an outlier on the Z floor;
its float32 against its float64 at T = 4096; and its launches a call of
each entry point.
The plain-torch engines (the training path, IHGP's DARE bank and steady
passes in their three forms) run on the card against the same code on the
CPU, IHGP's through K5 and K6 on the card.
Tolerances relative to the reference's max |value|: 1e-9 in float64 (the
two differ in summation order and FMA contraction only), 1e-4 in float32
at these short lengths.
"""

import numpy as np
import pytest
import torch

from nsgp_tpu_torch.inference.ep import EPConfig, ep_infer
from nsgp_tpu_torch.models.gtnmf import GTNMFModel, GTNMFParams, sample_prior, stack_params
from nsgp_tpu_torch.ops import fused_kalman as fk
from nsgp_tpu_torch.ops.kalman import Sites
from torch_threads import one_torch_thread  # noqa: F401

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


def _vjp_pair(model, params, y, mask, seed=7, only_lZ=False):
    """K7 and its twin on the same inputs: K3's outputs on the card and
    seeded normal cotangents on all five (or on lZ alone)."""
    ssm = model.build_ssm(params)
    mp = model.moment_params()
    dt_, dev = ssm.A.dtype, ssm.A.device
    wn, xi = fk.sigma_points(mp, dt_, dev)
    args = (y.to(dt_), mask.to(dt_), ssm.A, ssm.Q, ssm.Pinf, ssm.H, params.W, xi, wn, params.lik)
    kw = dict(damp=0.5, link=mp.link, variant=mp.variant, z_floor=mp.z_floor)
    outs = fk.fused_adf(*args, **kw)
    rng = np.random.default_rng(seed)
    cots = [torch.tensor(rng.normal(size=tuple(o.shape)), dtype=dt_, device=dev)
            if i == 2 or not only_lZ else None for i, o in enumerate(outs)]
    kern = lambda: fk.fused_adf_vjp(*args, outs[0], outs[1], *cots, **kw)
    plain = lambda: fk.fused_adf_vjp_plain(*args, outs[0], outs[1], *cots, **kw)
    return kern, plain


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("k1,k2,N,link,variant,only_lZ,stash", [
    ("exp", "exp", 3, "exp", "sq", False, True),  # bs 1, S = 77
    ("matern32", "exp", 2, "softplus", "amp", True, True),  # bs 2
    ("matern32", "matern52", 3, "softplus", "sq", False, True),  # bs 3, S = 77
    ("exp", "matern72", 4, "softplus", "sq", False, True),  # bs 4, S = 193: two rounds
    ("matern32", "matern52", 3, "softplus", "sq", False, False),  # no per-point record
])
def test_adf_vjp_kernel_matches_plain(cuda, monkeypatch, k1, k2, N, link, variant, only_lZ,
                                      stash, dtype):
    """Through the per-point record, and (a byte budget of 0) through the
    walk that re-evaluates the points."""
    if not stash:
        monkeypatch.setattr(fk, "VJP_STASH_BYTES", 0)
    model, params, ssm, y, mask = _case(k1, k2, 3, N, dtype, cuda, link, variant)
    kern, plain = _vjp_pair(model, params, y, mask, only_lZ=only_lZ)
    fk.reset_launches()
    got = kern()
    assert fk.fused_adf_vjp.launches == 1
    assert fk.fused_adf_vjp.stashed == int(stash)
    assert all(torch.equal(a, b) for a, b in zip(got, kern()))  # the same bits twice
    ref = plain()
    assert [g.shape for g in got] == [r.shape for r in ref]
    assert all(bool(torch.isfinite(g).all()) for g in got)
    assert _rel(got, ref) <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,k2", [(torch.float64, "matern52"), (torch.float32, "matern52"),
                                      (torch.float64, "se")])
def test_adf_vjp_kernel_at_mixture_width(cuda, dtype, k2):
    """D=48, N=9, 3973 sigma points: one CTA walks them in rounds (K3 takes
    a cluster of eight there), re-evaluating them (too many for the walk to
    read a per-point record), a gap and an outlier under the Z floor.  With
    SE modulators (block size 6) in float64 the walk's ring cannot hold the
    steps' predictions at this width, and the walk derives them again.  In
    float32 the bar is the one chip_smoke.py holds every float32 kernel to
    (1e-3): 3973 points summed in another order than the twin's, whose
    weights at the outlier keep few digits (2.8e-4 measured on an H100)."""
    model, pB, yB, maskB = _files(1, 48, 9, dtype, cuda, k2=k2, steps=12)
    y = yB[:, 0].clone()
    y[6] = 50.0 * y.std()
    p = pB.select(0)
    assert fk.sigma_points(model.moment_params(), dtype, cuda)[0].shape[0] == 3973
    kern, plain = _vjp_pair(model, p, y, maskB[:, 0])
    fk.reset_launches()
    got = kern()
    assert (fk.fused_adf_vjp.launches, fk.fused_adf_vjp.stashed) == (1, 0)
    assert all(torch.equal(a, b) for a, b in zip(got, kern()))
    assert _rel(got, plain()) <= {torch.float64: 1e-9, torch.float32: 1e-3}[dtype]


@pytest.mark.cuda
def test_adf_vjp_refuses_what_it_cannot_run(cuda):
    dt_ = torch.float32
    model, params, ssm, y, mask = _case("matern32", "matern52", 3, 2, dt_, cuda)
    wn, xi = fk.sigma_points(model.moment_params(), dt_, cuda)
    args = [y, mask.to(dt_), ssm.A, ssm.Q, ssm.Pinf, ssm.H, params.W, xi, wn, params.lik]
    kw = dict(damp=0.5, link="softplus", variant="amp", z_floor=1e-10)
    ms, Ps, lZ, tt, tn = fk.fused_adf(*args, **kw)
    with pytest.raises(ValueError, match="g_lZ has shape"):
        fk.fused_adf_vjp(*args, ms, Ps, None, None, lZ[:-1], None, None, **kw)
    with pytest.raises(ValueError, match="unsupported link"):
        fk.fused_adf_vjp(*args, ms, Ps, None, None, lZ, None, None,
                         **dict(kw, link="relu"))
    with pytest.raises(TypeError):  # one dtype, float32 or float64
        fk.fused_adf_vjp(*args, ms, Ps, None, None, lZ.double(), None, None, **kw)
    with pytest.raises(ValueError, match="one device"):
        fk.fused_adf_vjp(*args, ms, Ps, None, None, lZ.cpu(), None, None, **kw)
    # more subbands than a warp's lanes take, four a lane
    model, pB, yB, maskB = _files(1, 130, 2, dt_, cuda, k1="exp", k2="exp", steps=4)
    p = pB.select(0)
    ssm = model.build_ssm(p)
    wn, xi = fk.sigma_points(model.moment_params(), dt_, cuda)
    args = [yB[:, 0], maskB[:, 0].to(dt_), ssm.A, ssm.Q, ssm.Pinf, ssm.H, p.W, xi, wn, p.lik]
    C, bs = ssm.H.shape
    with pytest.raises(ValueError, match="at most 128 subbands"):
        fk.fused_adf_vjp(*args, torch.zeros((4, C, bs), device=cuda),
                         torch.zeros((4, C, bs, bs), device=cuda), None, None,
                         torch.ones(4, device=cuda), None, None, **kw)


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


# ---------------------------------------------------------------------------
# The training path on the card: sweep 1 through K3 and its adjoint K7,
# later sweeps autograd through the sequential engine, held against the same
# code on the CPU (the two twins) at float64.
# ---------------------------------------------------------------------------

TRAIN_TOL = 1e-9


def _train_case(dtype=torch.float64, variant="sq", T_=48):
    rng = np.random.default_rng(5)
    model = GTNMFModel(D=3, N=2, kernel1="exp", kernel2="matern52", variant=variant,
                       p_cubature=7)
    params = GTNMFParams(
        lik=np.float64(1e-2), sub_var=np.full(3, 0.5), sub_len=np.linspace(40.0, 120.0, 3),
        omega=np.linspace(0.2, 1.4, 3), mod_var=np.full(2, 2.0),
        mod_len=np.linspace(150.0, 300.0, 2), W=rng.uniform(0.2, 1.0, (3, 2))).to(dtype=dtype)
    y, _, _ = sample_prior(torch.Generator().manual_seed(2), model, params, T_)
    return model, params, y


def _grads(energy, params, dev):
    from nsgp_tpu_torch.models.gtnmf import PARAM_NAMES

    leaves = {k: getattr(params, k).detach().to(dev).requires_grad_(True) for k in PARAM_NAMES}
    e = energy(GTNMFParams(**leaves), dev)
    return [e, *torch.autograd.grad(e, list(leaves.values()))]


@pytest.mark.cuda
@pytest.mark.parametrize("itts", [1, 3])
def test_ep_energy_gradient_card_matches_cpu(cuda, itts):
    from nsgp_tpu_torch.inference.ep import EPConfig, ep_energy

    model, params, y = _train_case()
    y[20:26] = float("nan")
    energy = lambda p, dev: ep_energy(model, p, y, None, EPConfig(ep_itts=itts), device=dev)
    fk.reset_launches()
    card = _grads(energy, params, cuda)
    assert card[0].device.type == "cuda"
    assert {fn.__name__: fn.launches for fn in fk.WRAPPERS} == {
        "fused_fwd": 0, "fused_bwd": 0, "fused_adf": 1, "fused_adf_mb": 0, "fused_adf_vjp": 1,
        "fused_resite": itts - 1}
    assert fk.fused_adf_vjp.stashed == 1
    assert _rel([x.cpu() for x in card], _grads(energy, params, "cpu")) <= TRAIN_TOL


@pytest.mark.cuda
def test_fit_two_steps_card_matches_cpu(cuda):
    from nsgp_tpu_torch.inference.learn import fit_hyperparams

    model, params, y = _train_case()
    specs = {"lik": "fixed", "sub_var": "fixed", "omega": "fixed", "sub_len": (20.0, 400.0),
             "mod_var": (1.0, 10.0), "mod_len": (50.0, 800.0), "W": (0.0, 1.5)}
    fit = lambda dev: fit_hyperparams(model, params, y, specs=specs, steps=2,
                                      learning_rate=1e-2, device=dev, ep_itts=1)
    card, cpu = fit(None), fit("cpu")
    assert card.energies.device.type == "cuda" and card.energies.shape == (2,)
    assert _rel([card.energies.cpu(), *(x.cpu() for x in card.params.leaves())],
                [cpu.energies, *cpu.params.leaves()]) <= TRAIN_TOL


def _speech_fit(dev, T_=16000):
    """``fit_hyperparams`` as the training cell runs it: the trained speech
    model (D=16, N=3, exp/matern52, 'sq', 77 sigma points) in float32, lik
    1e-3, clipped into the ``SPECS`` boxes, on T_ samples of seeded noise."""
    import os

    from nsgp_tpu_torch.convert import load_trained
    from nsgp_tpu_torch.experiments import with_lik
    from nsgp_tpu_torch.experiments.train_hyperopt import SPECS, _clip_into
    from nsgp_tpu_torch.inference.learn import fit_hyperparams

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    model, params = load_trained(os.path.join(root, "results", "trained", "speech",
                                              "trained_speech0_female_exp.npz"),
                                 device=dev, dtype=torch.float32)
    init = _clip_into(with_lik(params, 1e-3))
    y = torch.randn(T_, generator=torch.Generator().manual_seed(7)).to(dev)
    return lambda steps: fit_hyperparams(model, init, y, specs=SPECS, steps=steps,
                                         learning_rate=1e-2, device=dev, ep_itts=1)


@pytest.mark.cuda
def test_fit_steps_never_sync(cuda):
    """No host-device synchronisation in a fit step: at the training cell's
    shapes, two steps of ``fit_hyperparams`` under
    ``torch.cuda.set_sync_debug_mode("error")``, which raises at the first
    sync, inside an outer ``deferred_stationarity`` scope that reads their
    two checks once the mode is back to default.  A one-step fit first makes
    the constants a process caches (sigma points, ``expm``'s, ``pad_eye``).
    Counted the same way (mode "warn", one warning a sync), a step
    synchronised 31 times before ``ops.ssm.expm`` and the deferral (NVIDIA
    H100): 16 subbands' [1, 0] rows and 6 of the modulators' L and H copied
    from the host, 3 in ``torch.linalg.matrix_exp`` and 3 in its backward,
    ``pad_eye`` from numpy, ``check_stationary``'s read, and ``ep_energy``'s
    write of ``last_only[-1]``."""
    fit = _speech_fit(cuda)
    fit(1)
    fk.reset_launches()
    with fk.deferred_stationarity():
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = fit(2)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert fk.check_stationary.deferred == 2
    assert fk.fused_adf.launches == 2 and fk.fused_adf_vjp.launches == 2
    assert torch.isfinite(out.energies).all()


@pytest.mark.cuda
def test_giekf_energy_gradient_card_matches_cpu(cuda):
    from nsgp_tpu_torch.inference.giekf import GIEKFConfig, giekf_energy, giekf_infer

    model, params, y = _train_case(variant="amp")
    energy = lambda p, dev: giekf_energy(model, p, y, None, device=dev)
    assert _rel([x.cpu() for x in _grads(energy, params, cuda)],
                _grads(energy, params, "cpu")) <= TRAIN_TOL
    cfg = GIEKFConfig(g_iter=2, l_iter=3)
    card, cpu = (giekf_infer(model, params, y, None, cfg, device=d) for d in (None, "cpu"))
    assert _rel([card.Eft.cpu(), card.Varft.cpu(), card.nll.cpu()],
                [cpu.Eft, cpu.Varft, cpu.nll]) <= TRAIN_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_giekf_batch_card_matches_single_file(cuda, dtype):
    """``giekf_infer_batch`` over three files (hyperparameters, gaps and a
    padded tail that differ per file) against single-file ``giekf_infer``
    on the card, file by file; at float64 also the batch on the card
    against the batch on the CPU."""
    from nsgp_tpu_torch.inference.batched import giekf_infer_batch
    from nsgp_tpu_torch.inference.giekf import GIEKFConfig, giekf_infer

    cases = [_train_case(dtype, variant="amp") for _ in range(3)]
    model = cases[0][0]
    plist, ys = [], []
    for b, (_, p, y) in enumerate(cases):
        p = GTNMFParams(*(x * (1.0 + 0.05 * b) if k != "W" else x
                          for k, x in zip(("lik", "sub_var", "sub_len", "omega", "mod_var",
                                           "mod_len", "W"), p.leaves())))
        plist.append(p)
        ys.append(y * (1.0 + 0.1 * b))
    paramsB, yB = stack_params(plist), torch.stack(ys)
    maskB = torch.ones_like(yB, dtype=torch.bool)
    for b in range(3):
        maskB[b, 8 + 10 * b: 14 + 10 * b] = False
        maskB[b, yB.shape[1] - 4 * b:] = False
    cfg = GIEKFConfig(g_iter=3, l_iter=2)
    card = giekf_infer_batch(model, paramsB, yB, maskB, cfg)
    assert card.Eft.device.type == "cuda" and card.Ps.shape[:2] == yB.shape
    for b in range(3):
        one = giekf_infer(model, plist[b], yB[b], maskB[b], cfg)
        assert _rel([card.Eft[b], card.Varft[b], card.nll[b]],
                    [one.Eft, one.Varft, one.nll]) <= TOL[dtype]
    if dtype == torch.float64:
        cpu = giekf_infer_batch(model, paramsB, yB, maskB, cfg, device="cpu")
        assert _rel([card.Eft.cpu(), card.Varft.cpu(), card.nll.cpu()],
                    [cpu.Eft, cpu.Varft, cpu.nll]) <= TRAIN_TOL


# ---------------------------------------------------------------------------
# The IHGP engine on the card: K5 and K6 against their plain twins; the DARE
# bank, the three forms of the steady passes and the energy's gradient, held
# against the same code on the CPU at float64.
# ---------------------------------------------------------------------------


def _ihgp_case():
    model, params, _ = _train_case(variant="amp")
    model = model._replace(kernel1="matern32")  # modulators (matern52) padded to bs=4
    y, _, _ = sample_prior(torch.Generator().manual_seed(3), model, params, 100)
    y[40:50] = float("nan")
    return model, params, y


@pytest.mark.cuda
def test_ihgp_tables_card_match_cpu(cuda):
    from nsgp_tpu_torch.inference import ihgp

    model, params, _ = _ihgp_case()
    for cfg in (ihgp.IHGPConfig(), ihgp.IHGPConfig(grid_lo=-7.0, pf_correct=0.5)):
        card = ihgp.build_tables(model.build_ssm(params.on(cuda)), cfg)
        cpu = ihgp.build_tables(model.build_ssm(params), cfg)
        assert card.Ph.device.type == "cuda"
        assert _rel([x.cpu() for x in card], list(cpu)) <= TRAIN_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("form", [dict(), dict(parallel=True, chunk=32),
                                  dict(parallel=True, chunk=0)])
def test_ihgp_infer_card_matches_cpu(cuda, form):
    """Three forms; T = 100 is a ragged multiple of the blocked chunk."""
    from nsgp_tpu_torch.inference import ihgp

    model, params, y = _ihgp_case()
    from nsgp_tpu_torch.ops import fused_ihgp as fih

    cfg = ihgp.IHGPConfig(ep_itts=3, damping=(0.1, 0.025), keep_best=True, **form)
    fih.reset_launches()
    card = ihgp.ihgp_infer(model, params, y, None, cfg)
    # the sequential form: K5 and K6 every sweep; the parallel forms: K5 once
    seq = not cfg.parallel
    assert (fih.fused_ihgp_adf.launches, fih.fused_ihgp_smooth.launches) == (
        (3, 3) if seq else (1, 0))
    cpu = ihgp.ihgp_infer(model, params, y, None, cfg, device="cpu")
    assert card.Eft.device.type == "cuda"
    assert _rel([card.Eft.cpu(), card.Varft.cpu(), card.lZ.cpu(), card.nlZ.cpu(),
                 *(s.cpu() for s in card.sites)],
                [cpu.Eft, cpu.Varft, cpu.lZ, cpu.nlZ, *cpu.sites]) <= TRAIN_TOL


@pytest.mark.cuda
def test_ihgp_energy_gradient_card_matches_cpu(cuda):
    from nsgp_tpu_torch.inference.ihgp import ihgp_energy

    from nsgp_tpu_torch.ops import fused_ihgp as fih

    model, params, y = _ihgp_case()
    energy = lambda p, dev: ihgp_energy(model, p, y, None, device=dev)
    fih.reset_launches()
    card = _grads(energy, params, cuda)
    # the sweep through FusedIHGPADF: K5 forward, K8 backward, once each
    assert (fih.fused_ihgp_adf.launches, fih.fused_ihgp_adf_vjp.launches) == (1, 1)
    assert all(bool(torch.isfinite(g).all()) for g in card)
    assert _rel([x.cpu() for x in card], _grads(energy, params, "cpu")) <= TRAIN_TOL



def _steady_pass(model, params, y, mask, sites, match, damp=0.1, grid_lo=-2.0):
    """One sequential IHGP forward pass through K5 and through its plain
    twin on the same inputs: ((ms, idx, lZ, ttau, tnu) of each)."""
    from nsgp_tpu_torch.inference import ihgp
    from nsgp_tpu_torch.ops import fused_ihgp as fih
    from nsgp_tpu_torch.ops.kalman import Sites

    ssm = model.build_ssm(params)
    tables = ihgp.build_tables(ssm, ihgp.IHGPConfig(grid_lo=grid_lo), smoother=False)
    run = lambda sweep: ihgp._steady_filter_seq(
        ssm, tables, y, mask, Sites(*sites), model.moment_params(), params.W, params.lik, damp,
        match, sweep=sweep)
    fih.reset_launches()
    got = run(fih.fused_ihgp_adf)
    assert fih.fused_ihgp_adf.launches == 1 and got[0].device.type == "cuda"
    ms, idx, lZ, s = got
    ms_p, idx_p, lZ_p, s_p = run(fih.fused_ihgp_adf_plain)
    return (ms, idx, lZ, s.ttau, s.tnu), (ms_p, idx_p, lZ_p, s_p.ttau, s_p.tnu)


def _steady_agree(got, ref, dtype):
    """float64: grid indices equal and the rest within 1e-9; float32: a
    flipped index (one ulp of the lookup's argument) sends the trajectory
    elsewhere, so the steps before the first flip within 1e-4 and at most
    1% of the indices flipped."""
    flips = got[1] != ref[1]
    if dtype == torch.float64:
        assert not bool(flips.any())
        assert _rel([got[0], got[2], got[3], got[4]], [ref[0], ref[2], ref[3], ref[4]]) <= 1e-9
        return
    rows = flips.any(dim=1)
    n = int(rows.nonzero()[0, 0]) if bool(rows.any()) else rows.shape[0]
    assert float(flips.double().mean()) <= 0.01
    if n:
        assert _rel([x[:n] for x in (got[0], got[2], got[3], got[4])],
                    [x[:n] for x in (ref[0], ref[2], ref[3], ref[4])]) <= TOL[dtype]


def _gap_signal(model, params, steps, seed):
    y, _, _ = sample_prior(torch.Generator().manual_seed(seed), model, params, steps)
    mask = torch.ones(steps, dtype=torch.bool, device=y.device)
    mask[steps // 3: steps // 3 + 8] = False
    return y, mask


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", ["adf", "last_only", "zero_sites"])
def test_ihgp_adf_kernel_matches_plain(cuda, case, dtype):
    """K5 on the toy of ``_ihgp_case``: the ADF sweep (zero sites, every
    step matched) with a gap; a later pass of the sequential form (the last
    step matched, fixed sites elsewhere, non-zero on the unobserved steps:
    their next row comes from tt, their index from tt_eff = 0); fixed sites
    that are exactly 0 on a third of the steps (the pure-prediction branch)."""
    model, params, y = _ihgp_case()
    params = params.to(dtype=dtype, device=cuda)
    mask = ~torch.isnan(y).to(cuda)
    y = torch.nan_to_num(y).to(cuda, dtype)
    steps, C = y.shape[0], model.D + model.N
    rng = np.random.default_rng(11)
    tt = rng.uniform(0.0, 40.0, (steps, C)) * (rng.uniform(size=(steps, C)) > 0.33)
    tn = rng.normal(size=(steps, C)) * tt
    sites = [torch.tensor(x, dtype=dtype, device=cuda) for x in (tt, tn)]
    match = torch.ones(steps, dtype=torch.bool, device=cuda)
    if case == "adf":
        sites = [torch.zeros_like(sites[0])] * 2
    else:
        match[:-1] = False
    if case == "zero_sites":
        mask = torch.ones_like(mask)
    got, ref = _steady_pass(model, params, y, mask, sites, match)
    _steady_agree(got, ref, dtype)
    gap = ~mask
    if case == "adf":  # unobserved: lZ = 0, the top of the grid
        assert float(got[2][gap].abs().max()) == 0.0
        assert bool((got[1][gap] == 199).all())
    if case == "last_only":  # the fixed sites pass through; idx from tt_eff = 0
        assert torch.equal(got[3][:-1], sites[0][:-1]) and torch.equal(got[4][:-1], sites[1][:-1])
        assert bool((got[1][gap] == 199).all())
    again, _ = _steady_pass(model, params, y, mask, sites, match)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("D,N,link,variant,steps", [
    (3, 4, "exp", "sq", 64),  # 193 sigma points: two tiles
    (48, 9, "softplus", "sq", 24),  # mixture width: 3973 points, a cluster of eight CTAs
])
def test_ihgp_adf_kernel_other_widths(cuda, D, N, link, variant, steps, dtype):
    model, pB, _, _ = _files(1, D, N, dtype, cuda, link, variant, steps=steps)
    params = pB.select(0)
    y, mask = _gap_signal(model, params, steps, seed=4)
    zeros = torch.zeros((steps, D + N), dtype=dtype, device=cuda)
    match = torch.ones(steps, dtype=torch.bool, device=cuda)
    got, ref = _steady_pass(model, params, y, mask, (zeros, zeros), match, grid_lo=-7.0)
    _steady_agree(got, ref, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("steps", [1, 2, 9, 17, 100])
@pytest.mark.parametrize("bs", [1, 2, 3, 4, 5, 8])
def test_ihgp_smooth_kernel_matches_plain(cuda, bs, steps, dtype):
    """K6 against its twin at every block class (channels a warp 32 // bs,
    idle lanes at bs = 3, 5), around its block of 8 (4 at bs > 4) steps,
    C = 19 channels over G = 200 gains."""
    from nsgp_tpu_torch.ops import fused_ihgp as fih

    rng = np.random.default_rng(bs * 100 + steps)
    C, G = 19, 200
    mk = lambda *s: torch.tensor(rng.normal(size=s), dtype=dtype, device=cuda)
    A = mk(C, bs, bs) * (0.9 / bs)
    Gn = mk(C, G, bs, bs) * (0.9 / bs)
    ms = mk(steps, C * bs)
    idx = torch.tensor(rng.integers(0, G, (steps, C)), device=cuda)
    fih.reset_launches()
    got = fih.fused_ihgp_smooth(ms, idx, A, Gn)
    assert fih.fused_ihgp_smooth.launches == 1
    ref = fih.fused_ihgp_smooth_plain(ms, idx, A, Gn)
    assert got.shape == ref.shape and _rel([got], [ref]) <= TOL[dtype]
    assert torch.equal(got[-1], ms[-1])


@pytest.mark.cuda
def test_ihgp_wrappers_refuse_what_they_cannot_run(cuda):
    from nsgp_tpu_torch.ops import fused_ihgp as fih

    A = torch.zeros((4, 2, 2), device=cuda)
    with pytest.raises(ValueError, match="Gn has shape"):
        fih.fused_ihgp_smooth(torch.zeros((5, 8), device=cuda),
                              torch.zeros((5, 4), dtype=torch.long, device=cuda), A,
                              torch.zeros((4, 10, 2, 3), device=cuda))
    model, params, y = _ihgp_case()
    params = params.on(cuda)
    y = torch.nan_to_num(y).to(cuda)
    ones = torch.ones(y.shape[0], device=cuda)  # float flags: refused
    zeros = torch.zeros((y.shape[0], model.D + model.N), dtype=y.dtype, device=cuda)
    with pytest.raises(ValueError, match="bool"):
        _steady_pass(model, params, y, ones, (zeros, zeros), ones > 0)


def _ihgp_vjp_pair(model, params, y, mask, sites, match, only_lZ=False, seed=7):
    """K8 and its twin on the same inputs: K5's outputs on the card (the
    forward's indices for both) and seeded normal cotangents on ms, lZ, ttau
    and tnu (or on lZ alone)."""
    from nsgp_tpu_torch.inference import ihgp
    from nsgp_tpu_torch.ops import fused_ihgp as fih

    ssm = model.build_ssm(params)
    tables = ihgp.build_tables(ssm, ihgp.IHGPConfig(grid_lo=-7.0), smoother=False)
    H = ssm.H
    tab = torch.cat([tables.Ph, tables.hPph[..., None]], dim=-1)
    first = torch.cat([(ssm.Pinf @ H[..., None])[..., 0],
                       torch.einsum("ci,cij,cj->c", H, ssm.Pinf, H)[:, None]], dim=-1)
    args = (y, mask, match, *sites, ssm.A, H, first, tab, fih.lookup_consts(tables.log_r),
            params.W, params.lik)
    kw = dict(mp=model.moment_params(), damp=0.5)
    ms, idx, lZ, tt, tn = fih.fused_ihgp_adf(*args, **kw)
    rng = np.random.default_rng(seed)
    g = [torch.tensor(rng.normal(size=tuple(o.shape)), dtype=y.dtype, device=y.device)
         for o in (ms, lZ, tt, tn)]
    if only_lZ:
        g = [None, g[1], None, None]
    kern = lambda: fih.fused_ihgp_adf_vjp(*args, ms, idx, tt, *g, **kw)
    plain = lambda: fih.fused_ihgp_adf_vjp_plain(*args, ms, idx, tt, *g, **kw)
    return kern, plain, (args, (ms, idx, tt), kw)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("D,N,k1,k2,link,variant,case,steps", [
    (16, 3, "matern32", "matern52", "softplus", "amp", "adf", 64),  # the headline width, bs 4
    (16, 3, "matern32", "matern52", "exp", "sq", "lZ", 64),
    (3, 2, "exp", "matern32", "softplus", "sq", "later", 64),  # bs 3, fixed sites, last matched
    (3, 4, "exp", "exp", "exp", "amp", "adf", 48),  # bs 1, 193 sigma points: two rounds
    (48, 9, "exp", "matern52", "softplus", "sq", "adf", 12),  # mixture width: 3973 points
])
def test_ihgp_adf_vjp_kernel_matches_plain(cuda, D, N, k1, k2, link, variant, case, steps, dtype):
    """K8, the reverse of K5's sweep (the backward of ``FusedIHGPADF``),
    against its plain twin on K5's outputs, with a NaN gap: all four
    cotangents or lZ's alone; a later pass of the sequential form (fixed
    non-zero sites on the unobserved steps, a third exactly 0, the last step
    matched).  At mixture width one CTA walks the points in rounds and the
    table's sums live in the scratch.  float32 is held to chip_smoke.py's
    bar (1e-3): the reverse sums T steps of float32 cotangents."""
    from nsgp_tpu_torch.ops import fused_ihgp as fih

    model, pB, _, _ = _files(1, D, N, dtype, cuda, link, variant, k1=k1, k2=k2, steps=steps)
    params = pB.select(0)
    y, mask = _gap_signal(model, params, steps, seed=4)
    C = D + N
    match = torch.ones(steps, dtype=torch.bool, device=cuda)
    sites = [torch.zeros((steps, C), dtype=dtype, device=cuda)] * 2
    if case == "later":
        rng = np.random.default_rng(11)
        tt = rng.uniform(0.0, 40.0, (steps, C)) * (rng.uniform(size=(steps, C)) > 0.33)
        sites = [torch.tensor(x, dtype=dtype, device=cuda)
                 for x in (tt, rng.normal(size=(steps, C)) * tt)]
        match[:-1] = False
    kern, plain, _ = _ihgp_vjp_pair(model, params, torch.nan_to_num(y), mask, sites, match,
                                    only_lZ=case == "lZ")
    fih.reset_launches()
    got = kern()
    assert fih.fused_ihgp_adf_vjp.launches == 1
    assert all(torch.equal(a, b) for a, b in zip(got, kern()))  # the same bits twice
    ref = plain()
    assert [g.shape for g in got] == [r.shape for r in ref]
    assert all(bool(torch.isfinite(g).all()) for g in got)
    assert _rel(got, ref) <= {torch.float64: 1e-9, torch.float32: 1e-3}[dtype]


@pytest.mark.cuda
def test_ihgp_adf_vjp_refuses_what_it_cannot_run(cuda):
    from nsgp_tpu_torch.ops import fused_ihgp as fih

    model, params, y = _ihgp_case()
    y = torch.nan_to_num(y).to(cuda)
    steps, C = y.shape[0], model.D + model.N
    seen = torch.ones(steps, dtype=torch.bool, device=cuda)
    zeros = torch.zeros((steps, C), dtype=y.dtype, device=cuda)
    _, _, (args, (ms, idx, tt), kw) = _ihgp_vjp_pair(model, params.on(cuda), y, seen,
                                                     (zeros, zeros), seen)
    g = torch.ones(steps, dtype=y.dtype, device=cuda)
    run = lambda *rest, a=args: fih.fused_ihgp_adf_vjp(*a, *rest, **kw)
    with pytest.raises(ValueError, match="g_lZ has shape"):
        run(ms, idx, tt, None, g[:-1], None, None)
    with pytest.raises(ValueError, match="idx has shape"):
        run(ms, idx[:-1], tt, None, g, None, None)
    with pytest.raises(TypeError):  # one dtype, float32 or float64
        run(ms, idx, tt, None, g.float(), None, None)
    with pytest.raises(ValueError, match="one device"):
        run(ms, idx, tt, None, g.cpu(), None, None)
    with pytest.raises(ValueError, match="bool"):  # float flags
        run(ms, idx, tt, None, g, None, None, a=(args[0], g) + args[2:])
    assert fih.fused_ihgp_adf_vjp(*args, ms, idx, tt, None, g, None, None, **kw)[0].is_cuda


def _speechlike_signal(T, seed=21):
    """Narrow-band noise at four centres under a slow positive envelope."""
    rng = np.random.default_rng(seed)
    w = np.fft.rfftfreq(T) * 2 * np.pi
    y = 0.1 * rng.normal(size=T)
    for k, f in enumerate((0.3, 0.9, 1.7, 2.6)):
        x = np.fft.irfft(np.fft.rfft(rng.normal(size=T)) * np.exp(-0.5 * ((w - f) / 0.01) ** 2), T)
        y += x / x.std() * (1.0 + 0.5 * k)
    env = np.convolve(rng.normal(size=T + 600), np.exp(-0.5 * (np.arange(-300, 301) / 150.0) ** 2),
                      "valid")[:T]
    return y * np.logaddexp(env / 10.0, 0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["exp", "matern32"])
def test_pretraining_pipeline_card_matches_cpu(cuda, kernel):
    """``train_gtnmf_fixed_params`` at T = 1024 (D=4, N=2, the Whittle fit
    cut to 2 levels of 40 steps, one NMF start given to both), float64: every
    field of the trained model card vs CPU.  On this signal the fit is well
    conditioned (a 1e-14 perturbation of y moves it by 1e-14)."""
    from nsgp_tpu_torch.models.gtnmf import PARAM_NAMES
    from nsgp_tpu_torch.pretrain.pipeline import train_gtnmf_fixed_params

    T = 1024
    y = torch.tensor(_speechlike_signal(T))
    gen = torch.Generator().manual_seed(0)
    init = tuple(torch.rand(s, generator=gen, dtype=torch.float64) + 0.5
                 for s in ((8, T, 2), (8, 4, 2)))
    card, cpu = (train_gtnmf_fixed_params(
        y, D=4, N=2, kernel1=kernel, fs=2000.0, nmf_init=init, device=d,
        filterbank_kwargs=dict(num_levels=2, min_win=128, max_win=512, steps_per_level=40))
        for d in (None, "cpu"))
    assert card.H.device.type == "cuda"
    pick = lambda tm: [getattr(tm.params, k) for k in PARAM_NAMES] + [tm.envelopes, tm.H] + list(
        tm.fit)
    assert _rel([x.cpu() for x in pick(card)], pick(cpu)) <= TRAIN_TOL


@pytest.mark.cuda
def test_denoise_card_matches_cpu(cuda):
    """``denoise(backend="fused")`` (K3, K2, K1 on the card, their plain
    versions on the CPU) at T = 512 with the trained speech model, float64,
    and the time-varying Wiener read-out of its posterior."""
    from pathlib import Path

    from nsgp_tpu_torch.apps.denoise import denoise, stationary_spectrum, tv_wiener
    from nsgp_tpu_torch.convert import load_trained

    root = Path(__file__).resolve().parents[1]
    tm = load_trained(root / "results" / "trained" / "speech" / "trained_speech0_female_exp.npz",
                      device="cpu", dtype=torch.float64, full=True)
    y, _, _ = sample_prior(torch.Generator().manual_seed(3), tm.model, tm.params, 512)
    y = y / y.std() + 0.2 * torch.randn(512, generator=torch.Generator().manual_seed(4),
                                        dtype=torch.float64)
    S = stationary_spectrum("exp", tm.fit.sigma2, tm.fit.lengthscales("exp"), tm.fit.omega,
                            dtype=torch.float64)
    outs = []
    for d in (None, "cpu"):
        r = denoise(tm.model, tm.params, y, 0.04, n_samples=0, device=d, backend="fused",
                    ep_itts=5, ep_fraction=0.75, damping=(0.1,))
        w = tv_wiener(tm.model, tm.params.on(r.y_hat.device), r.result.Eft, y.to(r.y_hat.device),
                      0.04, stat_spec=S.to(r.y_hat.device), stat_floor=1.0)
        outs.append([r.result.Eft.cpu(), r.result.Varft.cpu(), r.y_hat.cpu(), w.cpu()])
    assert _rel(*outs) <= TRAIN_TOL


def _channel_rank(rank, T):
    """A rank of a 2-rank gloo world on the one card: fused EP (K3, then K1
    and K2 on the rank's channels) sharded by channel, against the unsharded
    call on the same rank; float64, D=16, N=3 (C = 19 split 10/9)."""
    from nsgp_tpu_torch.inference.ep import EPConfig, ep_infer
    from nsgp_tpu_torch.parallel import mesh as pmesh

    dev = torch.device("cuda")
    D, N = 16, 3
    rng = np.random.default_rng(0)
    model = GTNMFModel(D=D, N=N, kernel1="matern32", kernel2="matern52", p_cubature=9)
    params = GTNMFParams(
        lik=np.float64(1e-3), sub_var=np.ones(D), sub_len=np.linspace(50.0, 300.0, D),
        omega=np.linspace(0.05, 2.8, D), mod_var=np.full(N, 2.0),
        mod_len=np.linspace(800.0, 2500.0, N), W=rng.uniform(0.1, 1.0, (D, N)),
    ).to(dtype=torch.float64, device=dev)
    y, _, _ = sample_prior(torch.Generator().manual_seed(5), model, params, T)
    cfg = EPConfig(ep_itts=3, backend="fused")
    ref = ep_infer(model, params, y, None, cfg)
    fk.reset_launches()
    res = pmesh.shard_inference_over_channels(model, params, y, pmesh.make_mesh({"channel": 2}),
                                              cfg)
    launches = {fn.__name__: fn.launches for fn in fk.WRAPPERS}
    fields = ("Eft", "Varft", "nlZ", "ms", "Ps", "lZ")
    return dict(rel=_rel([getattr(res, f) for f in fields], [getattr(ref, f) for f in fields]),
                launches=launches, device=res.Eft.device.type, index=res.Eft.device.index)


@pytest.mark.cuda
def test_channel_sharded_fused_ep_on_card(cuda, tmp_path):
    """``shard_inference_over_channels`` on the fused path, 2 ranks sharing
    the card over gloo (NCCL refuses two ranks on one GPU): each rank's
    result equals the unsharded call at 1e-9, K3 runs once (replicated),
    K1 and K2 on the rank's 10 or 9 channels as often as unsharded."""
    from nsgp_tpu_torch.ops import _build
    from nsgp_tpu_torch.parallel import mesh as pmesh

    _build.library()  # once, before the ranks load it
    ranks = pmesh.spawn_world(_channel_rank, 2, "gloo", (1000,), root=str(tmp_path))
    for r in ranks:
        assert r["device"] == "cuda" and r["rel"] <= TOL[torch.float64], r
        assert r["launches"] == {"fused_fwd": 2, "fused_bwd": 3, "fused_adf": 1,
                                 "fused_adf_mb": 0, "fused_adf_vjp": 0, "fused_resite": 2}, r


@pytest.mark.cuda
@pytest.mark.skipif(torch.cuda.device_count() < 2, reason="nccl runs one GPU a rank: needs 2 GPUs")
def test_channel_sharded_fused_ep_over_nccl(cuda, tmp_path):
    """The same split over nccl, one GPU a rank: rank r runs on GPU r and
    its result equals the unsharded call at 1e-9."""
    from nsgp_tpu_torch.ops import _build
    from nsgp_tpu_torch.parallel import mesh as pmesh

    _build.library()
    ranks = pmesh.spawn_world(_channel_rank, 2, "nccl", (1000,), root=str(tmp_path))
    for rank, r in enumerate(ranks):
        assert r["device"] == "cuda" and r["index"] == rank, r
        assert r["rel"] <= TOL[torch.float64], r
        assert r["launches"]["fused_adf"] == 1, r


# ---------------------------------------------------------------------------
# K9, the all-T re-site, against its plain twin (the re-site's path under
# autograd and on the CPU), and where the entry points launch it
# ---------------------------------------------------------------------------


def _resite_case(D, N, steps, dtype, dev, link="softplus", variant="sq", pep=False,
                 tt_hi=2.0, seed=0):
    """A model of D subbands and N modulators (77 sigma points at N = 3,
    3973 at N = 9) with marginals and sites of ``steps`` steps: a masked run
    (NaN in y), a subband and a modulator whose cavity variance is not
    positive (their sites are kept), and an outlier whose every
    log-normaliser lies under the raw-scale Z floor."""
    rng = np.random.default_rng(seed)
    model = GTNMFModel(D=D, N=N, kernel1="exp", kernel2="matern52", link=link, variant=variant,
                       p_cubature=9, use_pep_const=pep)
    params = GTNMFParams(
        lik=np.float64(0.05), sub_var=np.linspace(0.5, 1.5, D) / D,
        sub_len=np.linspace(20.0, 80.0, D), omega=np.linspace(0.1, 2.5, D),
        mod_var=np.full(N, 0.5), mod_len=np.linspace(300.0, 600.0, N),
        W=rng.uniform(0.2, 1.0, (D, N)),
    ).to(dtype=dtype, device=dev)
    C = D + N
    f = lambda x: torch.tensor(x, dtype=dtype, device=dev)
    mu, var = f(rng.normal(size=(steps, C)) * 0.5), f(rng.uniform(0.05, 1.5, (steps, C)))
    tt, tn = f(rng.uniform(0.0, tt_hi, (steps, C))), f(rng.normal(size=(steps, C)))
    tt[1, 0] = tt[2, D] = 50.0
    y = f(rng.normal(size=steps))
    y[3] = 1e6
    mask = torch.ones(steps, dtype=torch.bool, device=dev)
    mask[5:9] = False
    y[5:9] = float("nan")
    return model, params, y, mask, mu, var, Sites(tt, tn)


def _resite_pair(model, params, y, mask, mu, var, sites, exclude_last=False):
    """K9 through ``_ep_resite`` and the plain twin on the same card tensors."""
    from nsgp_tpu_torch.inference import ep as ep_mod

    cfg = EPConfig(ep_fraction=0.75)
    got, lZ = ep_mod._ep_resite(model, params, cfg, y, mask, mu, var, sites, 0.3, exclude_last)
    ref_mask = mask.clone()
    if exclude_last:
        ref_mask[-1] = False
    ref = fk.fused_resite_plain(model.moment_params(), y, ref_mask, mu, var, sites.ttau,
                                sites.tnu, params.W, params.lik, frac=0.75, damp=0.3)
    return (got.ttau, got.tnu, lZ), ref


@pytest.mark.cuda
@pytest.mark.parametrize("D,N,link,variant,pep,exclude_last", [
    (16, 3, "softplus", "sq", False, False),
    (16, 3, "softplus", "amp", False, False),
    (16, 3, "exp", "sq", False, True),
    (16, 3, "exp", "amp", False, False),
    (16, 3, "softplus", "sq", True, False),  # use_pep_const
    (3, 2, "softplus", "amp", False, True),  # one lane a point: every lane does all its points
    (48, 9, "softplus", "sq", False, False),  # mixture width, 3973 points
    (48, 9, "exp", "sq", True, True),
])
def test_resite_kernel_matches_plain(cuda, D, N, link, variant, pep, exclude_last):
    """float64 K9 against the plain twin at rtol 1e-11 of each output's
    largest value; the same bits twice; masked steps keep their (clamped)
    sites and read lZ = 0."""
    steps = 24 if N == 9 else 64
    case = _resite_case(D, N, steps, torch.float64, cuda, link, variant, pep)
    fk.reset_launches()
    got, ref = _resite_pair(*case, exclude_last=exclude_last)
    assert fk.fused_resite.launches == 1
    assert _rel(got, ref) <= 1e-11
    again, _ = _resite_pair(*case, exclude_last=exclude_last)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    sites = case[-1]
    assert torch.equal(got[0][5:9], sites.ttau[5:9].clamp_min(0.0))
    assert torch.equal(got[1][5:9], sites.tnu[5:9]) and float(got[2][5:9].abs().max()) == 0.0
    assert float(got[0][1, 0]) == 50.0 and float(got[0][2, D]) == 50.0  # v_raw <= 0: kept
    if not pep:
        assert float(got[2][3]) == pytest.approx(np.log(1e-10), rel=1e-12)  # on the Z floor
    if exclude_last:
        assert float(got[2][-1]) == 0.0


@pytest.mark.cuda
def test_resite_kernel_on_an_ill_conditioned_site(cuda):
    """'exp' amplitudes at mixture width: one modulator's update has
    1 + d2 v_cav = 1.85e-4, so both float64 paths lose about four digits
    there (K9 1.6e-9 and the plain twin 2.4e-9 from an 80-bit evaluation of
    the same site; they read 1.7e-9 apart).  K9 and the twin agree within
    5e-9 of each output's largest value."""
    from nsgp_tpu_torch.ops.moments import moments_chunked

    case = _resite_case(48, 9, 24, torch.float64, cuda, "exp", "amp")
    model, params, y, mask, mu, var, sites = case
    vraw = 1.0 / (1.0 / var - 0.75 * sites.ttau)
    ok = (vraw > 0.0) & mask[:, None]
    vc = torch.where(ok, vraw, torch.ones_like(vraw))
    mc = torch.where(ok, vraw * (mu / var - 0.75 * sites.tnu), torch.zeros_like(vraw))
    d2 = moments_chunked(model.moment_params(), params.lik, y, mc, vc, params.W, 0.75)[2]
    den = float((1.0 + d2 * vc)[ok].min())
    assert 1e-4 < den < 1e-3
    got, ref = _resite_pair(*case)
    assert _rel(got, ref) <= 5e-9


@pytest.mark.cuda
@pytest.mark.parametrize("D,N", [(16, 3), (48, 9)])
def test_resite_kernel_float32_follows_float64(cuda, D, N):
    """K9 in float32 against K9 in float64 on the same inputs, T = 4096,
    within 5e-5 of each output's largest value."""
    case = _resite_case(D, N, 4096, torch.float64, cuda, tt_hi=0.5)
    model, params, y, mask, mu, var, sites = case
    f64 = _resite_pair(*case)[0]
    to32 = lambda x: x.to(torch.float32)
    params32 = GTNMFParams(*(to32(x) for x in params.leaves()))
    f32 = _resite_pair(model, params32, to32(y), mask, to32(mu), to32(var),
                       Sites(to32(sites.ttau), to32(sites.tnu)))[0]
    assert all(bool(torch.isfinite(x).all()) for x in f32)
    assert _rel([x.double() for x in f32], f64) <= 5e-5


@pytest.mark.cuda
def test_resite_refuses_what_it_cannot_run(cuda):
    model, params, y, mask, mu, var, sites = _resite_case(16, 3, 16, torch.float64, cuda)
    mp = model.moment_params()
    kw = dict(frac=0.75, damp=0.3)
    fk.reset_launches()
    with pytest.raises(ValueError, match="bool mask"):
        fk.fused_resite(mp, y, mask.double(), mu, var, sites.ttau, sites.tnu, params.W,
                        params.lik, **kw)
    with pytest.raises(ValueError, match="shape"):
        fk.fused_resite(mp, y, mask, mu, var[:, :-1], sites.ttau, sites.tnu, params.W,
                        params.lik, **kw)
    with pytest.raises(TypeError):
        fk.fused_resite(mp, y.float(), mask, mu, var, sites.ttau, sites.tnu, params.W,
                        params.lik, **kw)
    assert fk.fused_resite.launches == 0


@pytest.mark.cuda
def test_entry_points_launch_the_resite_kernel(cuda):
    """K9 launches: ``ep_infer`` (fused, 3 sweeps) 2; ``separate`` (10 sweeps)
    9; ``fill_gaps_batch`` 0 at one sweep and BF at two; ``ep_energy`` (3
    sweeps) 2 for its value and gradient: the backward recomputes the plain
    twin and launches none."""
    from nsgp_tpu_torch.inference.ep import ep_energy
    from nsgp_tpu_torch.apps.missing_data import fill_gaps_batch
    from nsgp_tpu_torch.apps.source_sep import separate

    model, params, _, _, _ = _case("matern32", "matern52", 3, 2, torch.float32, cuda)
    ys = [sample_prior(torch.Generator().manual_seed(s), model, params, 128)[0] for s in (1, 2)]
    runs = {
        "ep_infer": (lambda: ep_infer(model, params, ys[0], None,
                                      EPConfig(backend="fused", ep_itts=3)), 2),
        "separate": (lambda: separate([model, model], [params, params], ys[0] + ys[1],
                                      engine="ep", backend="fused", ep_itts=10, n_samples=0), 9),
        "ep_energy": (lambda: _grads(lambda p, dev: ep_energy(model, p, ys[0], None,
                                                           EPConfig(ep_itts=3), device=dev),
                                     params, cuda), 2),
    }
    BF = 3
    modelB, pB, yB, maskB = _files(BF, 3, 2, torch.float32, cuda, steps=128)
    for itts, want in ((1, 0), (2, BF)):
        runs[f"fill_gaps_batch, {itts} sweeps"] = (
            lambda itts=itts: fill_gaps_batch(modelB, pB, yB.T, maskB.T, engine="ep",
                                              backend="fused", ep_itts=itts, n_samples=0), want)
    for name, (run, want) in runs.items():
        fk.reset_launches()
        run()
        torch.cuda.synchronize()
        assert fk.fused_resite.launches == want, name
