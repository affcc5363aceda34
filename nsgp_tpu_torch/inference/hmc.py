"""HMC and mean-field VI over hyperparameters.

Port of ``nsgp_tpu/inference/hmc.py`` (nothing comparable in the reference,
whose only hyperlearning is fminunc with finite differences): the EP/GIEKF
energy is the negative log-likelihood; sampling runs in the unconstrained
space of ``learn.Transform`` with the log-|Jacobian| correction.

A ``torch.Generator`` takes the place of the JAX key.  Chains run one after
another, each on a CPU generator seeded from the caller's, so a seed gives
the same draws on the card and on the CPU.  The flat vector follows JAX's
``ravel_pytree`` order, which sorts the dict keys (``W, lik, mod_len,
mod_var, omega, sub_len, sub_var``): ``samples[..., j]`` means the same
parameter in both packages.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from nsgp_tpu_torch.inference.learn import Transform
from nsgp_tpu_torch.models.gtnmf import GTNMFParams


class HMCConfig(NamedTuple):
    n_samples: int = 100
    n_warmup: int = 100
    n_leapfrog: int = 16
    init_step_size: float = 0.02
    target_accept: float = 0.8


class HMCResult(NamedTuple):
    samples: torch.Tensor  # (chains, n_samples, dim) unconstrained draws
    accept_rate: torch.Tensor  # (chains,)
    step_size: torch.Tensor  # (chains,) adapted step sizes
    unravel: Callable  # dim-vector -> unconstrained dict


def ravel(u: dict):
    """(flat (dim,), unravel) in ``jax.flatten_util.ravel_pytree``'s order:
    keys sorted, each leaf flattened row-major."""
    keys = sorted(u)
    shapes = [u[k].shape for k in keys]
    sizes = [math.prod(s) for s in shapes]
    flat = torch.cat([u[k].reshape(-1) for k in keys])

    def unravel(q: torch.Tensor) -> dict:
        return {k: x.reshape(s) for k, x, s in zip(keys, torch.split(q, sizes), shapes)}

    return flat, unravel


def _log_jacobian(tf: Transform, u: dict) -> torch.Tensor:
    """log |d constrained / d unconstrained| summed over parameters."""
    total = 0.0
    for g, uu in u.items():
        spec = tf.specs.get(g, "log")
        if isinstance(spec, tuple):
            lo, hi = spec
            s = torch.sigmoid(uu)
            total = total + torch.sum(math.log(hi - lo) + torch.log(s) + torch.log1p(-s))
        else:
            total = total + torch.sum(uu)  # d exp(u)/du = exp(u)
    return total


def make_log_post(energy_fn, tf: Transform, ref: GTNMFParams,
                  log_prior: Optional[Callable] = None):
    """Unnormalized log posterior over the unconstrained dict."""

    def log_post(u):
        params = tf.to_params(u, ref)
        lp = -energy_fn(params) + _log_jacobian(tf, u)
        if log_prior is not None:
            lp = lp + log_prior(params)
        return lp

    return log_post


def _value_and_grad(logp: Callable, q: torch.Tensor):
    q = q.detach().requires_grad_(True)
    lp = logp(q)
    (g,) = torch.autograd.grad(lp, q)
    return lp.detach(), g


def leapfrog(logp: Callable, q, p, eps: float, n_leapfrog: int, grad_q=None):
    """``n_leapfrog`` leapfrog steps of size ``eps`` from (q, p), as the JAX
    package's (a half step of p, full steps, a half step).  ``grad_q`` is the
    gradient at q if known.  Returns (q1, p1, logp(q1), grad at q1)."""
    if grad_q is None:
        grad_q = _value_and_grad(logp, q)[1]
    p = p + 0.5 * eps * grad_q
    for _ in range(n_leapfrog - 1):
        q = q + eps * p
        p = p + eps * _value_and_grad(logp, q)[1]
    q = q + eps * p
    lp, g = _value_and_grad(logp, q)
    return q, p + 0.5 * eps * g, lp, g


def _child_generators(generator: torch.Generator, n: int):
    seeds = torch.randint(0, 2**62, (n,), generator=generator, device=generator.device)
    return [torch.Generator().manual_seed(int(s)) for s in seeds]


def _randn(gen, shape, like):
    return torch.randn(shape, generator=gen, dtype=like.dtype).to(like.device)


def _hmc_chain(gen, logp, flat0, config: HMCConfig, jitter_init: float):
    """One chain: draws after warm-up, mean acceptance after warm-up, final
    step size.  Dual averaging (Nesterov) toward ``target_accept`` during
    warm-up; afterwards the step size is the averaged one."""
    dim = flat0.shape[0]
    q = flat0 + jitter_init * _randn(gen, (dim,), flat0)
    lp, g = _value_and_grad(logp, q)
    log_eps0 = math.log(config.init_step_size)
    log_eps, h_bar, log_eps_bar = log_eps0, 0.0, log_eps0
    qs, accs = [], []
    for t in range(config.n_warmup + config.n_samples):
        p0 = _randn(gen, (dim,), flat0)
        u = torch.rand((), generator=gen, dtype=flat0.dtype).item()
        q1, p1, lp1, g1 = leapfrog(logp, q, p0, math.exp(log_eps), config.n_leapfrog, g)
        dH = (lp1 - 0.5 * p1 @ p1) - (lp - 0.5 * p0 @ p0)
        accept_p = torch.minimum(torch.ones_like(dH), torch.exp(dH)).item()
        if not math.isfinite(accept_p):
            accept_p = 0.0
        if u < accept_p:
            q, lp, g = q1, lp1, g1
        if t < config.n_warmup:
            tt = t + 1.0
            h_bar = ((1.0 - 1.0 / (tt + 10.0)) * h_bar
                     + (config.target_accept - accept_p) / (tt + 10.0))
            log_eps = log_eps0 - math.sqrt(tt) / 0.05 * h_bar
            w = tt ** (-0.75)
            log_eps_bar = w * log_eps + (1.0 - w) * log_eps_bar
        else:
            log_eps = log_eps_bar
        qs.append(q)
        accs.append(accept_p)
    w0 = config.n_warmup
    return (torch.stack(qs[w0:]), sum(accs[w0:]) / max(config.n_samples, 1),
            math.exp(log_eps))


def hmc_sample(
    generator: torch.Generator,
    log_post: Callable,
    u_init: dict,
    config: HMCConfig = HMCConfig(),
    n_chains: int = 4,
    jitter_init: float = 0.05,
) -> HMCResult:
    """Vanilla HMC with dual-averaging step-size adaptation; the chains one
    after another, each from ``u_init`` jittered by ``jitter_init``."""
    flat0, unravel = ravel({k: v.detach() for k, v in u_init.items()})
    logp = lambda q: log_post(unravel(q))
    chains = [_hmc_chain(gen, logp, flat0, config, jitter_init)
              for gen in _child_generators(generator, n_chains)]
    samples, acc, eps = zip(*chains)
    as_t = lambda xs: torch.tensor(xs, dtype=flat0.dtype, device=flat0.device)
    return HMCResult(samples=torch.stack(samples), accept_rate=as_t(acc),
                     step_size=as_t(eps), unravel=unravel)


# ---------------------------------------------------------------------------
# Mean-field VI (reparameterized Gaussian over unconstrained params)
# ---------------------------------------------------------------------------


class VIResult(NamedTuple):
    mean: torch.Tensor  # (dim,)
    log_std: torch.Tensor  # (dim,)
    elbo_trace: torch.Tensor  # (steps,) ELBO estimate before each update
    unravel: Callable


def vi_fit(
    generator: torch.Generator,
    log_post: Callable,
    u_init: dict,
    steps: int = 300,
    n_mc: int = 4,
    learning_rate: float = 1e-2,
) -> VIResult:
    """Mean-field Gaussian VI with reparameterized ELBO gradients, Adam on
    (mean, log_std) from (u_init, -2); ``n_mc`` draws a step, evaluated one
    after another."""
    flat0, unravel = ravel({k: v.detach() for k, v in u_init.items()})
    dim = flat0.shape[0]
    mu = flat0.clone().requires_grad_(True)
    log_std = torch.full_like(flat0, -2.0).requires_grad_(True)
    opt = torch.optim.Adam([mu, log_std], lr=learning_rate)
    (gen,) = _child_generators(generator, 1)
    entropy_const = 0.5 * dim * (1.0 + math.log(2 * math.pi))
    trace = []
    for _ in range(steps):
        eps = _randn(gen, (n_mc, dim), flat0)
        qs = mu[None] + torch.exp(log_std)[None] * eps
        lps = torch.stack([log_post(unravel(q)) for q in qs])
        elbo = torch.mean(lps) + torch.sum(log_std) + entropy_const
        opt.zero_grad()
        (-elbo).backward()
        opt.step()
        trace.append(elbo.detach())
    return VIResult(mean=mu.detach(), log_std=log_std.detach(), elbo_trace=torch.stack(trace),
                    unravel=unravel)
