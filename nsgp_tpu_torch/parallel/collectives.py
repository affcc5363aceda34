"""The exchanges of the sharded EP paths, on plain tensors.

``parallel.mesh`` and the passes that read a mesh axis (``inference.ep``
under ``EPConfig.channel_axis`` / ``time_axis``, ``ops.bscan`` with a time
axis) exchange only through the functions here, which count what they issue
(``collective_stats``).  Every exchange is one ``all_reduce``:

- a *gather* is an all_reduce (SUM) of a zero-filled buffer of the full size
  into which each rank has written its own slice: one code for uneven slices
  (an all_gather wants equal ones) under either backend, and exact, since
  every element is its owner's value plus zeros.
- a *sum* or *max* is a plain all_reduce.

``gather`` and ``scatter`` carry a gradient for a computation that is
replicated on every rank around a sharded middle (``ep_energy`` under
``channel_axis``): a gather's backward takes the own slice of the
(replicated) gradient; a scatter's backward gathers the ranks' slices of the
gradient back into the full one.

The ambient mesh (``set_mesh``) is the counterpart of
``jax.sharding.set_mesh``: ``ep_infer`` and ``ep_energy`` resolve an axis
name of their config against it (``mesh_axis``).
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist


class Axis(NamedTuple):
    """One mesh dimension as this rank sees it."""

    name: str
    group: object  # the process group of the ranks along this dimension
    rank: int  # this rank's index along it
    size: int  # ranks along it

    def split(self, n: int):
        """This rank's contiguous run [lo, hi) of ``n`` items, as
        ``torch.tensor_split`` cuts them (the first ``n % size`` runs one
        longer)."""
        q, r = divmod(n, self.size)
        lo = self.rank * q + min(self.rank, r)
        return lo, lo + q + (1 if self.rank < r else 0)


_MESH = contextvars.ContextVar("nsgp_tpu_torch_mesh", default=None)


@contextlib.contextmanager
def set_mesh(mesh):
    """Make ``mesh`` (a ``DeviceMesh``) the ambient mesh inside the block."""
    token = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(token)


def mesh_axis(name: str) -> Optional[Axis]:
    """The ambient mesh's dimension ``name``; None for an empty name or a
    dimension of one rank (the unsharded path).  An axis without an ambient
    mesh raises ``RuntimeError``, as JAX's sharding constraint does; a name
    the mesh lacks raises ``ValueError``."""
    if not name:
        return None
    mesh = _MESH.get()
    if mesh is None:
        raise RuntimeError(f"mesh axis {name!r} needs an ambient mesh: run under "
                           f"nsgp_tpu_torch.parallel.mesh.set_mesh(mesh)")
    names = tuple(mesh.mesh_dim_names or ())
    if name not in names:
        raise ValueError(f"the ambient mesh has dimensions {names}, not {name!r}")
    size = mesh.size(names.index(name))
    if size == 1:
        return None
    return Axis(name, mesh.get_group(name), mesh.get_local_rank(name), size)


# ---------------------------------------------------------------------------
# What was issued, by kind: count and bytes handed to the collective
# ---------------------------------------------------------------------------

_STATS: dict = {}


def reset_collectives() -> None:
    _STATS.clear()


def collective_stats() -> dict:
    """{kind: {"count": n, "bytes": b}} since the last reset, this rank's."""
    return {k: {"count": c, "bytes": b} for k, (c, b) in sorted(_STATS.items())}


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def all_reduce(x: torch.Tensor, axis: Axis, op: str = "sum", kind: Optional[str] = None):
    """``x`` reduced over ``axis`` (a new tensor; ``x`` is left as it was)."""
    out = x.detach().clone()
    entry = _STATS.setdefault(kind or f"all_reduce_{op}", [0, 0])
    entry[0] += 1
    entry[1] += out.numel() * out.element_size()
    dist.all_reduce(out, op=_OPS[op], group=axis.group)
    return out


def _gather(x: torch.Tensor, axis: Axis, dim: int, lo: int, total: int, kind: str = "gather"):
    shape = list(x.shape)
    shape[dim] = total
    full = x.new_zeros(shape)
    full.narrow(dim, lo, x.shape[dim]).copy_(x)
    return all_reduce(full, axis, kind=kind)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim, lo, total, kind):
        ctx.slice = (dim, lo, x.shape[dim])
        return _gather(x, axis, dim, lo, total, kind)

    @staticmethod
    def backward(ctx, g):
        dim, lo, n = ctx.slice
        return g.narrow(dim, lo, n).contiguous(), None, None, None, None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim, lo, hi):
        ctx.meta = (axis, dim, lo, x.shape[dim])
        return x.narrow(dim, lo, hi - lo).clone()

    @staticmethod
    def backward(ctx, g):
        axis, dim, lo, total = ctx.meta
        return _gather(g, axis, dim, lo, total), None, None, None, None


def gather(x: torch.Tensor, axis: Axis, dim: int, lo: int, total: int,
           kind: str = "gather") -> torch.Tensor:
    """The whole of a tensor split along ``dim`` over ``axis``: this rank
    holds items [lo, lo + x.shape[dim]) of ``total``.  One collective,
    counted under ``kind``."""
    if x.requires_grad and torch.is_grad_enabled():
        return _Gather.apply(x, axis, dim, lo, total, kind)
    return _gather(x, axis, dim, lo, total, kind)


def scatter(x: torch.Tensor, axis: Axis, dim: int, lo: int, hi: int) -> torch.Tensor:
    """This rank's items [lo, hi) along ``dim`` of a replicated tensor; no
    exchange forward, one gather in the backward pass."""
    if x.requires_grad and torch.is_grad_enabled():
        return _Scatter.apply(x, axis, dim, lo, hi)
    return x.narrow(dim, lo, hi - lo)
