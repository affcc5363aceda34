"""Hyperparameter learning: constrained optimization of engine energies.

Port of ``nsgp_tpu/inference/learn.py``.  Replaces the reference's fminunc +
finite differences (train_model.m:222-246) with first-order optimization on
exact autograd gradients of the EP / GIEKF energies.

Constraint handling mirrors the reference's scaled-sigmoid
reparameterization (sigmoid.m / inv_sigmoid.m / unpack_params.m); each
parameter group can be
  - 'log'      : positive, optimized as log(x)           (default)
  - (lo, hi)   : box-constrained via  x = lo + (hi-lo) * sigmoid(u)
  - 'fixed'    : excluded from optimization (the reference's tune_hypers
                 mask, demo_toy_modulators_nmf_constraints.m:26-40)
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from nsgp_tpu_torch.models.gtnmf import GTNMFModel, GTNMFParams
from nsgp_tpu_torch.ops.fused_kalman import deferred_stationarity
from nsgp_tpu_torch.utils.device import resolve_device
from nsgp_tpu_torch.utils.trace import span, spanned

GROUPS = ("lik", "sub_var", "sub_len", "omega", "mod_var", "mod_len", "W")


def _fwd(spec, u):
    if isinstance(spec, tuple):
        lo, hi = spec
        return lo + (hi - lo) * torch.sigmoid(u)
    return torch.exp(u)  # 'log'


def _inv(spec, x):
    if isinstance(spec, tuple):
        lo, hi = spec
        p = torch.clamp((x - lo) / (hi - lo), 1e-6, 1.0 - 1e-6)
        return torch.log(p) - torch.log1p(-p)
    return torch.log(x)


class Transform(NamedTuple):
    """Bijective map between GTNMFParams and a dict of unconstrained tensors."""

    specs: dict  # group -> 'log' | 'fixed' | (lo, hi)

    def to_unconstrained(self, params: GTNMFParams) -> dict:
        return {g: _inv(self.specs.get(g, "log"), getattr(params, g))
                for g in GROUPS if self.specs.get(g, "log") != "fixed"}

    def to_params(self, u: dict, ref: GTNMFParams) -> GTNMFParams:
        kw = {}
        for g in GROUPS:
            spec = self.specs.get(g, "log")
            kw[g] = getattr(ref, g) if spec == "fixed" or g not in u else _fwd(spec, u[g])
        return GTNMFParams(**kw)


def make_energy_fn(model: GTNMFModel, y, mask=None, engine: str = "ep", device=None,
                   **cfg_kwargs) -> Callable[[GTNMFParams], torch.Tensor]:
    """params -> energy of the named engine on (y, mask).  Without kwargs EP
    uses the single-sweep ADF energy (``ep_itts=1``), GIEKF its defaults."""
    from nsgp_tpu_torch.inference import registry

    _, energy_fn, config_cls = registry.get_engine(engine)
    if cfg_kwargs:
        cfg = config_cls(**cfg_kwargs)
    else:
        cfg = config_cls(ep_itts=1) if engine == "ep" else config_cls()
    return lambda p: energy_fn(model, p, y, mask, cfg, device=device)


class FitResult(NamedTuple):
    params: GTNMFParams
    energies: torch.Tensor  # (steps,) energy at the parameters before each update
    final_energy: torch.Tensor


@spanned("nsgp.fit_hyperparams")
def fit_hyperparams(
    model: GTNMFModel,
    init_params: GTNMFParams,
    y,
    mask=None,
    engine: str = "ep",
    specs: Optional[dict] = None,
    steps: int = 100,
    learning_rate: float = 3e-2,
    optimizer=None,  # params list -> torch.optim.Optimizer; default Adam(lr)
    device=None,  # None = the card; "cpu" runs the plain versions
    **cfg_kwargs,
) -> FitResult:
    """Optimize the marginal-likelihood energy over (transformed) hypers.

    Equivalent of the reference's fminunc stage, with exact gradients.  The
    unconstrained leaves live on ``device`` with ``requires_grad``; each step
    calls ``optimizer.step`` with a closure (so L-BFGS works too).  As in the
    JAX package's scan, ``energies[i]`` is the loss before update i and
    ``final_energy`` is ``energies[-1]``.  The steps' stationarity checks
    (``fused_kalman.check_stationary``) are deferred to one read when the
    steps end, which raises the check's ValueError if any step failed it.
    """
    dev = resolve_device(device)
    init = init_params.on(dev)
    y = torch.as_tensor(y).to(dev)
    mask = None if mask is None else torch.as_tensor(mask).to(dev)
    tf = Transform(specs or {})
    energy = make_energy_fn(model, y, mask, engine, device=dev, **cfg_kwargs)
    u = {g: v.detach().clone().requires_grad_(True)
         for g, v in tf.to_unconstrained(init).items()}
    make_opt = optimizer or (lambda ps: torch.optim.Adam(ps, lr=learning_rate))
    opt = make_opt(list(u.values()))

    def closure():
        opt.zero_grad()
        loss = energy(tf.to_params(u, init))
        with span("nsgp.backward"):
            loss.backward()
        return loss

    def step():
        with span("nsgp.step"):
            return opt.step(closure).detach()

    with deferred_stationarity():
        energies = torch.stack([step() for _ in range(steps)])
    with torch.no_grad():
        params = tf.to_params(u, init)
    return FitResult(params=params, energies=energies, final_energy=energies[-1])
