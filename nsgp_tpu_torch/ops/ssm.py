"""Block-structured state-space model assembly and discretization.

Port of ``nsgp_tpu/ops/ssm.py`` (reference: matlab/ss_modulators_nmf.m,
ss_modulators.m, unifying_prob_tf/lti_disc.m, get_disc_model.m).

The joint filter covariance of the GT-NMF model is block-diagonal for all
time, so the dense joint system is never built: channels are stacked along
a leading axis as uniform padded blocks ``(C, bs, bs)``.

Channel layout (matches the reference's H-row order):
  channels 0..D-1   : subbands  (kernel1 x cosine product, block 2*tau1)
  channels D..D+N-1 : modulators (kernel2, block tau3)
Blocks smaller than bs are zero-padded; padding is inert (A=I, Q=0, Pinf=0,
H=0 on padded dims), so padded state/covariance entries remain exactly 0.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as Fn

from nsgp_tpu_torch.ops import kernels as K


class BlockSSM(NamedTuple):
    """Channel-stacked continuous/discrete state-space model.

    All tensors carry a leading channel axis C = D + N.
    """

    F: torch.Tensor  # (C, bs, bs) continuous-time feedback
    LQcLT: torch.Tensor  # (C, bs, bs) process-noise term L Qc L'
    H: torch.Tensor  # (C, bs)     per-channel observation row
    Pinf: torch.Tensor  # (C, bs, bs) stationary covariance
    A: torch.Tensor  # (C, bs, bs) discrete transition expm(F*dt)
    Q: torch.Tensor  # (C, bs, bs) discrete process noise
    pad_eye: torch.Tensor  # (C, bs, bs) identity on zero-padded dims (else 0)
    D: int  # number of subband channels
    N: int  # number of modulator channels

    @property
    def num_channels(self) -> int:
        return self.F.shape[0]

    @property
    def block_size(self) -> int:
        return self.F.shape[-1]


def _pad_block(M: torch.Tensor, bs: int) -> torch.Tensor:
    """Zero-pad a (t, t) block to (bs, bs)."""
    t = M.shape[0]
    return Fn.pad(M, (0, bs - t, 0, bs - t))


def _pad_row(h: torch.Tensor, bs: int) -> torch.Tensor:
    return Fn.pad(h, (0, bs - h.shape[0]))


# The degree-18 Taylor polynomial of Bader, Blanes & Casas, "Computing the
# matrix exponential with an optimized Taylor polynomial approximation"
# (Mathematics 7, 2019), with the coefficients and norm bounds that
# torch.linalg.matrix_exp takes: rows B1..B5 over (I, A, A^2, A^3, A^6), and
# the 1-norm up to which the polynomial needs no scaling, by dtype.
_T18 = (
    (0.0, -1.00365581030144618291e-01, -8.02924648241156932449e-03,
     -8.92138498045424779339e-04, 0.0),
    (0.0, 3.97849749499645077844e-01, 1.36783778460411719922e+00,
     4.98289622525382669416e-01, -6.37898194594723280150e-04),
    (-1.09676396052962061844e+01, 1.68015813878906206114e+00, 5.71779846478865511061e-02,
     -6.98210122488052056106e-03, 3.34975017086070470649e-05),
    (-9.04316832390810593223e-02, -6.76404519071381882256e-02, 6.75961301770459654925e-02,
     2.95552570429315521194e-02, -1.39180257516060693404e-05),
    (0.0, 0.0, -9.23364619367118555360e-02, -1.69364939002081722752e-02,
     -1.40086798182036094347e-05),
)
_T18_THETA = {torch.float64: 1.090863719290036e+00, torch.float32: 3.010066362817634e+00}
EXPM_SQUARINGS = 7  # the cover: ||M||_1 <= theta * 2**7 (139.6 in float64)


def expm_cover(dtype) -> float:
    """The largest 1-norm ``expm`` takes in ``dtype``."""
    return _T18_THETA[dtype] * 2.0**EXPM_SQUARINGS


@functools.lru_cache(maxsize=32)
def _expm_consts(n: int, dtype, device):
    """``expm``'s constants, made once per size, dtype and device and shared,
    so read-only: the polynomial's (5, 5, 1, 1, 1) coefficients, the norm bounds
    theta * 2**k for k = 0..EXPM_SQUARINGS, and the (n, n) identity."""
    bounds = [_T18_THETA[dtype] * 2.0**k for k in range(EXPM_SQUARINGS + 1)]
    return (torch.tensor(_T18, dtype=dtype, device=device)[..., None, None, None],
            torch.tensor(bounds, dtype=dtype, device=device),
            torch.eye(n, dtype=dtype, device=device))


def expm(M: torch.Tensor) -> torch.Tensor:
    """exp(M) over any leading axes, float32 or float64, with no
    host-device synchronisation: the same launches whatever M holds.

    The algorithm of ``torch.linalg.matrix_exp`` on a batch: each matrix is
    scaled by 2**-s, s = ceil(log2(||M||_1 / theta)) clamped at 0, the
    degree-18 polynomial is evaluated, and the result squared s times.  Here
    s stays on the device: the scaling and all EXPM_SQUARINGS squarings run
    for every matrix, a squaring past a matrix's own s multiplying by the
    identity (exact).  A matrix beyond the cover (``expm_cover``) comes out
    NaN, never a wrong value; so does one that holds NaN.  The gradient is
    autograd's, through the products.
    """
    n = M.shape[-1]
    if n <= 1:
        return M.exp()
    coef, bounds, eye = _expm_consts(n, M.dtype, M.device)
    X = M.reshape(-1, n, n)
    over = X.detach().abs().sum(-2).amax(-1)[:, None] > bounds  # (B, squarings + 1)
    X = X * torch.pow(0.5, over[:, :-1].sum(-1))[:, None, None]
    A2 = X @ X
    A3 = A2 @ X
    A6 = A3 @ A3
    powers = torch.stack([eye.expand_as(X), X, A2, A3, A6])
    B1, B2, B3, B4, B5 = (coef * powers).sum(1)  # as torch sums: term by term
    A9 = torch.baddbmm(B4, B1, B5)
    X = torch.baddbmm(B2, B3 + A9, A9)
    for k in range(EXPM_SQUARINGS):
        X = X @ torch.where(over[:, k, None, None], X, eye)
    return torch.where(over[:, -1, None, None], float("nan"), X).reshape(M.shape)


def subband_block(sigma2, ell, omega, kernel: str, dtype=None):
    """Quasi-periodic subband channel: kernel x cosine product.

    Ref: ss_modulators_nmf.m:49-78 —
      F_sm = kron(F1, I2) + kron(I_tau1, [[0,-w],[w,0]])
      L_sm = kron(L1, I2),  Qc_sm = Qc1 * I2,
      H_sm = kron(H1, [1,0]),  Pinf_sm = kron(Pinf1, I2).
    Returns (F, LQcLT, H_row, Pinf) of block size 2*tau1.
    """
    ss = K.get_kernel(kernel)(sigma2, ell, dtype=dtype)
    tau1 = ss.F.shape[0]
    dt_, dev = ss.F.dtype, ss.F.device
    I2 = torch.eye(2, dtype=dt_, device=dev)
    omega = torch.as_tensor(omega, dtype=dt_, device=dev)
    z = torch.zeros((), dtype=dt_, device=dev)
    rot = torch.stack([torch.stack([z, -omega]), torch.stack([omega, z])])
    F = torch.kron(ss.F, I2) + torch.kron(torch.eye(tau1, dtype=dt_, device=dev), rot)
    LQcLT = torch.kron(ss.L @ ss.Qc @ ss.L.T, I2)
    H = Fn.pad(ss.H[0][:, None], (0, 1)).reshape(-1)  # kron(H1, [1, 0])
    Pinf = torch.kron(ss.Pinf, I2)
    return F, LQcLT, H, Pinf


def modulator_block(sigma2, ell, kernel: str, dtype=None):
    """Slow-varying modulator channel.  Ref: ss_modulators_nmf.m:93-118."""
    ss = K.get_kernel(kernel)(sigma2, ell, dtype=dtype)
    LQcLT = ss.L @ ss.Qc @ ss.L.T
    return ss.F, LQcLT, ss.H[0], ss.Pinf


def lti_disc_matrix_fraction(F: torch.Tensor, LQcLT: torch.Tensor, dt: float = 1.0):
    """Exact LTI discretization by matrix-fraction decomposition.

    Ref: lti_disc.m:73-82.  A = expm(F dt); Q via the 2n x 2n exponential of
    [[F, LQcLT], [0, -F']].  Batched over any leading axes.
    """
    n = F.shape[-1]
    A = expm(F * dt)
    Phi = torch.cat(
        [torch.cat([F, LQcLT], -1),
         torch.cat([torch.zeros_like(F), -F.transpose(-1, -2)], -1)], -2
    )
    EPhi = expm(Phi * dt)
    AB_top = EPhi[..., :n, n:]
    AB_bot = EPhi[..., n:, n:]
    # AB_bot = expm(-F' dt) is never singular: the unchecked solve, which
    # does not read its status back to the host
    Q = torch.linalg.solve_ex(AB_bot.transpose(-1, -2), AB_top.transpose(-1, -2)).result
    Q = Q.transpose(-1, -2)
    return A, 0.5 * (Q + Q.transpose(-1, -2))


def lti_disc_stationary(F: torch.Tensor, Pinf: torch.Tensor, dt: float = 1.0):
    """Discretization via the stationarity identity Q = Pinf - A Pinf A'.

    Exact for stationary processes (all kernels here); one matrix
    exponential.  Batched over any leading axes.
    """
    A = expm(F * dt)
    Q = Pinf - A @ Pinf @ A.transpose(-1, -2)
    return A, 0.5 * (Q + Q.transpose(-1, -2))


def build_modulator_ssm(
    sub_sigma2,  # (D,)
    sub_ell,  # (D,)
    sub_omega,  # (D,)
    mod_sigma2,  # (N,)
    mod_ell,  # (N,)
    kernel1: str = "matern32",
    kernel2: str = "matern52",
    dt: float = 1.0,
    discretization: str = "stationary",
) -> BlockSSM:
    """Build the channel-stacked GT-NMF state-space model.

    Per-channel blocks padded to bs = max(2*tau1, tau3) and stacked on a
    leading channel axis; dtype and device follow ``sub_sigma2``.

    The model is assembled and discretized in float64 and cast to that dtype
    at the end: Q = Pinf - A Pinf A' cancels to ~1e-10 of Pinf for a trained
    lengthscale of 1e5 samples, which formed in float32 (eps 6e-8) comes out
    indefinite and drives the filter's variances negative over a long signal.
    """
    sub_sigma2 = torch.atleast_1d(torch.as_tensor(sub_sigma2))
    out_dtype, dev = sub_sigma2.dtype, sub_sigma2.device
    dtype = torch.float64
    sub_sigma2 = sub_sigma2.to(dtype)
    as1d = lambda x: torch.atleast_1d(torch.as_tensor(x, dtype=dtype, device=dev))
    sub_ell, sub_omega = as1d(sub_ell), as1d(sub_omega)
    mod_sigma2, mod_ell = as1d(mod_sigma2), as1d(mod_ell)
    D = sub_sigma2.shape[0]
    N = mod_sigma2.shape[0]
    tau1 = K.kernel_state_dim(kernel1)
    tau3 = K.kernel_state_dim(kernel2)
    bs = max(2 * tau1, tau3)

    blocks = []
    for d in range(D):
        F, LQ, H, P = subband_block(sub_sigma2[d], sub_ell[d], sub_omega[d], kernel1)
        blocks.append((_pad_block(F, bs), _pad_block(LQ, bs), _pad_row(H, bs),
                       _pad_block(P, bs)))
    for n in range(N):
        F, LQ, H, P = modulator_block(mod_sigma2[n], mod_ell[n], kernel2)
        blocks.append((_pad_block(F, bs), _pad_block(LQ, bs), _pad_row(H, bs),
                       _pad_block(P, bs)))
    F, LQcLT, H, Pinf = (torch.stack(x) for x in zip(*blocks))

    if discretization == "stationary":
        A, Q = lti_disc_stationary(F, Pinf, dt)
    else:
        A, Q = lti_disc_matrix_fraction(F, LQcLT, dt)

    leaves = (x.to(out_dtype) for x in (F, LQcLT, H, Pinf, A, Q))
    return BlockSSM(*leaves, _pad_eye(D, N, 2 * tau1, tau3, bs, out_dtype, dev), D=D, N=N)


@functools.lru_cache(maxsize=32)
def _pad_eye(D: int, N: int, t_sub: int, t_mod: int, bs: int, dtype, device) -> torch.Tensor:
    """``BlockSSM.pad_eye``: the identity on each channel's padded dims,
    made once per shape, dtype and device and shared, so read-only."""
    pad = np.zeros((D + N, bs))
    pad[:D, t_sub:] = 1.0
    pad[D:, t_mod:] = 1.0
    return torch.diag_embed(torch.as_tensor(pad, dtype=dtype, device=device))


def stack_ssms(ssms) -> BlockSSM:
    """Per-file models of one structure -> leaves with a leading file axis,
    (BF, C, ...).  Each file keeps its own stationary discretization."""
    first = ssms[0]
    leaves = [torch.stack(xs) for xs in zip(*(s[:7] for s in ssms))]
    return BlockSSM(*leaves, D=first.D, N=first.N)


def flatten_files(ssmB: BlockSSM) -> BlockSSM:
    """(BF, C, ...) -> (BF*C, ...), file-major: the channel axis the
    filter and smoother kernels take (they run any number of channels)."""
    BF = ssmB.F.shape[0]
    leaves = [x.reshape((-1,) + x.shape[2:]) for x in ssmB[:7]]
    return BlockSSM(*leaves, D=BF * ssmB.D, N=BF * ssmB.N)


# ---------------------------------------------------------------------------
# Dense materialization (tests / parity checks only)
# ---------------------------------------------------------------------------


def dense(ssm: BlockSSM):
    """Materialize the dense joint (F, H, Pinf, A, Q) as numpy, dropping
    padded dims.  Only for small-model tests."""
    Fh = ssm.F.detach().cpu().numpy()
    Ah = ssm.A.detach().cpu().numpy()
    Qh = ssm.Q.detach().cpu().numpy()
    Ph = ssm.Pinf.detach().cpu().numpy()
    Hh = ssm.H.detach().cpu().numpy()
    C = Fh.shape[0]
    sizes = []
    for c in range(C):
        nz = np.where(
            (np.abs(Fh[c]).sum(0) + np.abs(Fh[c]).sum(1) + np.abs(Ph[c]).sum(0)) > 0
        )[0]
        sizes.append(int(nz.max() + 1) if nz.size else 1)
    m = sum(sizes)
    Fd, Ad, Qd, Pd = (np.zeros((m, m)) for _ in range(4))
    Hd = np.zeros((C, m))
    off = 0
    for c, t in enumerate(sizes):
        s = slice(off, off + t)
        Fd[s, s] = Fh[c][:t, :t]
        Ad[s, s] = Ah[c][:t, :t]
        Qd[s, s] = Qh[c][:t, :t]
        Pd[s, s] = Ph[c][:t, :t]
        Hd[c, s] = Hh[c][:t]
        off += t
    return Fd, Hd, Pd, Ad, Qd
