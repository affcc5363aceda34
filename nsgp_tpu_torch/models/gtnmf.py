"""GT-NMF model family: parameters, assembly, prior sampling.

Port of ``nsgp_tpu/models/gtnmf.py``.  The Gaussian Time-Frequency + NMF
model of Wilkinson et al. (ICML 2019): D quasi-periodic subband GPs
amplitude-modulated by N (<= D) linked modulator GPs mixed through
nonnegative weights W (D x N).

Parameter vector layout matches the reference exactly
(gf_ep_modulator_nmf.m:72-75):

    w = log([lik; var_f (D); len_f (D); omega (D); var_s (N); len_s (N); W(:)])

with W flattened column-major (MATLAB order).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from nsgp_tpu_torch.ops import ssm as ssm_mod
from nsgp_tpu_torch.ops.moments import LINKS, MomentParams

PARAM_NAMES = ("lik", "sub_var", "sub_len", "omega", "mod_var", "mod_len", "W")


class GTNMFParams(nn.Module):
    """Natural-scale (positive) model hyperparameters, held as buffers.

    ``.to(device)`` / ``.double()`` move and cast all seven together.  A
    batch of files is the same module with a leading (BF,) axis on every
    buffer (``stack_params``); ``select(b)`` gives one file back.
    """

    lik: torch.Tensor  # () observation noise variance sn2
    sub_var: torch.Tensor  # (D,) subband marginal variances
    sub_len: torch.Tensor  # (D,) subband lengthscales
    omega: torch.Tensor  # (D,) subband center frequencies (rad/sample)
    mod_var: torch.Tensor  # (N,) modulator variances
    mod_len: torch.Tensor  # (N,) modulator lengthscales
    W: torch.Tensor  # (D, N) nonnegative NMF weights

    def __init__(self, lik, sub_var, sub_len, omega, mod_var, mod_len, W):
        super().__init__()
        for name, value in zip(PARAM_NAMES,
                               (lik, sub_var, sub_len, omega, mod_var, mod_len, W)):
            self.register_buffer(name, torch.as_tensor(value))

    @property
    def D(self) -> int:
        return self.sub_var.shape[-1]

    @property
    def N(self) -> int:
        return self.mod_var.shape[-1]

    def leaves(self) -> tuple:
        return tuple(getattr(self, name) for name in PARAM_NAMES)

    def on(self, device) -> "GTNMFParams":
        """A copy on ``device`` (``.to`` would move this module in place)."""
        return GTNMFParams(*(x.to(device) for x in self.leaves()))

    def select(self, b: int) -> "GTNMFParams":
        """File ``b`` of stacked parameters."""
        return GTNMFParams(*(x[b] for x in self.leaves()))

    def to_flat_log(self) -> torch.Tensor:
        """Pack to the reference's flat log-parameter vector ``w``."""
        return torch.cat(
            [
                torch.log(torch.atleast_1d(self.lik)),
                torch.log(self.sub_var),
                torch.log(self.sub_len),
                torch.log(self.omega),
                torch.log(self.mod_var),
                torch.log(self.mod_len),
                torch.log(self.W.T.reshape(-1)),  # column-major like MATLAB W(:)
            ]
        )

    @staticmethod
    def from_flat_log(w: torch.Tensor, D: int, N: int, num_lik: int = 1) -> "GTNMFParams":
        """Unpack the reference layout (gf_ep_modulator_nmf.m:72-75)."""
        lik = torch.exp(w[0]) if num_lik == 1 else torch.exp(w[:num_lik])
        o = num_lik
        ew = torch.exp(w)
        return GTNMFParams(
            lik=lik,
            sub_var=ew[o : o + D],
            sub_len=ew[o + D : o + 2 * D],
            omega=ew[o + 2 * D : o + 3 * D],
            mod_var=ew[o + 3 * D : o + 3 * D + N],
            mod_len=ew[o + 3 * D + N : o + 3 * D + 2 * N],
            W=ew[o + 3 * D + 2 * N :].reshape(N, D).T.contiguous(),  # undo column-major
        )


def stack_params(params_list) -> GTNMFParams:
    """Stack per-file parameters along a new leading (BF,) file axis."""
    return GTNMFParams(*(torch.stack(xs) for xs in zip(*(p.leaves() for p in params_list))))


class GTNMFModel(NamedTuple):
    """Static model specification."""

    D: int
    N: int
    kernel1: str = "matern32"  # subband kernel
    kernel2: str = "matern52"  # modulator kernel
    link: str = "softplus"
    variant: str = "amp"  # 'amp' | 'sq' (spectrogram/paper variant)
    p_cubature: int = 9
    cubature_method: str = "symmetric"
    use_pep_const: bool = False
    z_floor: float = 1e-10  # likModulatorNMFPower.m:28

    def moment_params(self) -> MomentParams:
        return MomentParams(
            D=self.D,
            N=self.N,
            p_cubature=self.p_cubature,
            link=self.link,
            variant=self.variant,
            method=self.cubature_method,
            use_pep_const=self.use_pep_const,
            z_floor=self.z_floor,
        )

    def build_ssm(self, params: GTNMFParams, dt: float = 1.0) -> ssm_mod.BlockSSM:
        return ssm_mod.build_modulator_ssm(
            params.sub_var,
            params.sub_len,
            params.omega,
            params.mod_var,
            params.mod_len,
            kernel1=self.kernel1,
            kernel2=self.kernel2,
            dt=dt,
        )

    def build_ssm_batch(self, paramsB: GTNMFParams, dt: float = 1.0) -> ssm_mod.BlockSSM:
        """Stacked parameters -> one ``BlockSSM`` with leaves (BF, C, ...)."""
        BF = paramsB.sub_var.shape[0]
        return ssm_mod.stack_ssms([self.build_ssm(paramsB.select(b), dt) for b in range(BF)])


def per_subband_params(lik, sub_var, sub_len, omega, mod_var, mod_len) -> GTNMFParams:
    """The non-NMF model (one modulator per subband, ss_modulators.m):
    equivalent to NMF with N = D and W = I."""
    sub_var = torch.atleast_1d(torch.as_tensor(sub_var))
    D = sub_var.shape[0]
    return GTNMFParams(
        lik=torch.as_tensor(lik),
        sub_var=sub_var,
        sub_len=torch.atleast_1d(torch.as_tensor(sub_len)),
        omega=torch.atleast_1d(torch.as_tensor(omega)),
        mod_var=torch.atleast_1d(torch.as_tensor(mod_var)),
        mod_len=torch.atleast_1d(torch.as_tensor(mod_len)),
        W=torch.eye(D, dtype=sub_var.dtype, device=sub_var.device),
    )


# ---------------------------------------------------------------------------
# Prior sampling (toy demos / synthetic experiments)
# ---------------------------------------------------------------------------


def _psd_sqrt(M: torch.Tensor) -> torch.Tensor:
    """Symmetric PSD square root via eigh (safe for padded singular blocks)."""
    lam, V = torch.linalg.eigh(M)
    lam = torch.clamp_min(lam, 0.0)
    return V @ (torch.sqrt(lam)[..., :, None] * V.transpose(-1, -2))


def sample_prior(
    generator: torch.Generator, model: GTNMFModel, params: GTNMFParams, T: int,
    dt: float = 1.0,
):
    """Sample latents and observations from the generative model.

    Ref demo_toy_modulators_nmf.m:40-53: z_k = A z_{k-1} + Q^{1/2} xi,
    y_k = z_sub' W link(g).  Noise is drawn from ``generator`` on its own
    device and moved to the parameters' device.  Returns (y (T,),
    subbands (T, D), modulator_latents (T, N)).
    """
    ssm = model.build_ssm(params, dt)
    C, bs = ssm.num_channels, ssm.block_size
    dt_, dev = ssm.A.dtype, ssm.A.device
    sqrtP = _psd_sqrt(ssm.Pinf)
    sqrtQ = _psd_sqrt(ssm.Q)
    noise = torch.randn((T, C, bs), generator=generator, dtype=dt_,
                        device=generator.device).to(dev)
    x = torch.einsum("cij,cj->ci", sqrtP, noise[0])
    xs = [x]
    for t in range(1, T):
        x = torch.einsum("cij,cj->ci", ssm.A, x) + torch.einsum("cij,cj->ci", sqrtQ, noise[t])
        xs.append(x)
    f = torch.einsum("ci,tci->tc", ssm.H, torch.stack(xs))  # (T, C)
    sub = f[:, : model.D]
    g = f[:, model.D :]
    amps = LINKS[model.link](g) @ params.W.T  # (T, D)
    if model.variant == "sq":
        amps = torch.sqrt(amps)
    y = torch.einsum("td,td->t", sub, amps)
    return y, sub, g
