"""Adam over a list of tensors, step for step as ``optax.adam``.

The JAX pretraining loops run ``optax.adam(lr)`` inside a ``lax.scan``; here
the loop is eager, one autograd gradient a step.  The update is optax's, in
its order of operations:

    m <- (1 - b1) g + b1 m,        v <- (1 - b2) g^2 + b2 v,
    p <- p + (-lr) * (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps)

``torch.optim.Adam`` computes the same update in another order (the bias
corrections folded into the step size and the denominator), which differs in
the last bits and drifts over hundreds of steps on a flat objective.  Nothing
here reads a value back to the host.
"""

from __future__ import annotations

import torch


def adam(loss, params, lr: float, steps: int, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8):
    """Minimise the sum of ``loss(*params)`` by ``steps`` Adam steps from
    ``params``.  A loss of several independent objectives (one a row of a
    batch) gives each its own gradient and, Adam being elementwise, its own
    trajectory.

    Returns (the parameters after the last step, the loss's value at the
    start of the last step): JAX's ``vals[-1]`` of the scan.  Each step adds
    one to ``adam.steps``."""
    params = [p.detach().contiguous() for p in params]
    m = [torch.zeros_like(p) for p in params]
    v = [torch.zeros_like(p) for p in params]
    val = None
    for t in range(1, steps + 1):
        leaves = [p.requires_grad_(True) for p in params]
        val = loss(*leaves)
        grads = torch.autograd.grad(val.sum(), leaves)
        c1, c2 = 1.0 - b1**t, 1.0 - b2**t
        with torch.no_grad():
            for i, g in enumerate(grads):
                m[i] = (1.0 - b1) * g + b1 * m[i]
                v[i] = (1.0 - b2) * (g * g) + b2 * v[i]
                params[i] = params[i].detach() + (-lr) * (
                    (m[i] / c1) / (torch.sqrt(v[i] / c2) + eps))
        adam.steps += 1
    return params, (val.detach() if val is not None else None)


adam.steps = 0
