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
    H = torch.kron(ss.H[0], torch.tensor([1.0, 0.0], dtype=dt_, device=dev))
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
    A = torch.linalg.matrix_exp(F * dt)
    Phi = torch.cat(
        [torch.cat([F, LQcLT], -1),
         torch.cat([torch.zeros_like(F), -F.transpose(-1, -2)], -1)], -2
    )
    EPhi = torch.linalg.matrix_exp(Phi * dt)
    AB_top = EPhi[..., :n, n:]
    AB_bot = EPhi[..., n:, n:]
    Q = torch.linalg.solve(AB_bot.transpose(-1, -2), AB_top.transpose(-1, -2))
    Q = Q.transpose(-1, -2)
    return A, 0.5 * (Q + Q.transpose(-1, -2))


def lti_disc_stationary(F: torch.Tensor, Pinf: torch.Tensor, dt: float = 1.0):
    """Discretization via the stationarity identity Q = Pinf - A Pinf A'.

    Exact for stationary processes (all kernels here); one matrix
    exponential.  Batched over any leading axes.
    """
    A = torch.linalg.matrix_exp(F * dt)
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

    pad = np.zeros((D + N, bs))
    pad[:D, 2 * tau1:] = 1.0
    pad[D:, tau3:] = 1.0
    pad_eye = torch.diag_embed(torch.as_tensor(pad, dtype=dtype, device=dev))
    leaves = (x.to(out_dtype) for x in (F, LQcLT, H, Pinf, A, Q, pad_eye))
    return BlockSSM(*leaves, D=D, N=N)


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
