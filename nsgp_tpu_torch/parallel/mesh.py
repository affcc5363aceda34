"""Device-mesh parallelism for GT-NMF inference and training.

Port of ``nsgp_tpu/parallel/mesh.py`` to ``torch.distributed``: a mesh is a
``DeviceMesh`` over the ranks of the current process group, one rank a
process.  Axes:

- ``data``    : independent signals.  Each rank takes its contiguous slice
                of the B files; the loss and every gradient are summed over
                the axis (JAX's automatic psum, made explicit).
- ``channel`` : channel blocks of one signal.  The block-diagonal filter and
                smoother passes split over C; the ADF sweep and the re-site,
                whose moment match couples every channel at each step, are
                replicated, and the (T, C) marginals are gathered before each
                re-site (``EPConfig.channel_axis``).
- ``time``    : the blocked scan's chunks of one signal: passes 1 and 3 on
                each rank's own chunks, the chunk totals exchanged in pass 2
                (``EPConfig.time_axis``).

JAX annotates the arrays and lets GSPMD insert the collectives, inside every
step of the sequential ADF scan as well.  Here the split is decided by hand
(``inference.ep``, ``ops.bscan``) and the few exchanges are explicit
all-reduces on plain tensors (``parallel.collectives``, which counts them):
DTensor's operator propagation does not reach the hand-written kernels or
the Python loops over T.  The JAX module's docstring names a third axis,
``chain`` (HMC/VI chains, ``inference/hmc.py``); the JAX package has no code
behind it, and neither has this one.

The collective backend is an argument of whatever sets up the group
(``spawn_world``, the CLIs): ``"nccl"`` for one GPU a rank, ``"gloo"`` when
the ranks share a card or run on the CPU.
"""

from __future__ import annotations

import math
import os
import tempfile
from typing import Optional

import torch
import torch.distributed as dist

from nsgp_tpu_torch.inference import ep
from nsgp_tpu_torch.inference.learn import Transform
from nsgp_tpu_torch.models.gtnmf import GTNMFModel, GTNMFParams
from nsgp_tpu_torch.parallel.collectives import all_reduce, gather, mesh_axis, set_mesh
from nsgp_tpu_torch.utils.device import resolve_device


def make_mesh(axis_sizes: dict, devices=None):
    """A ``DeviceMesh`` of shape ``axis_sizes.values()`` named by its keys,
    row-major over the ranks of the current process group (every rank
    calls it).  ``devices`` names where the ranks' tensors live: None = the
    card, ``"cpu"`` for a CPU world.  Raises ``ValueError`` when the mesh
    needs more ranks than the world has; a smaller mesh is allowed and the
    ranks outside it get None."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(torch.distributed.init_process_group, or spawn_world)")
    names = tuple(axis_sizes.keys())
    shape = tuple(int(s) for s in axis_sizes.values())
    n = math.prod(shape)
    if n > dist.get_world_size():
        raise ValueError(f"mesh needs {n} ranks, have {dist.get_world_size()}")
    mesh = init_device_mesh(resolve_device(devices).type, shape, mesh_dim_names=names)
    return mesh if mesh.get_coordinate() is not None else None


def data_sharding(mesh):
    """Placement of a batch split over the mesh's first dimension
    (JAX's ``P("data")``)."""
    from torch.distributed.tensor import Shard

    return [Shard(0)]


def replicated(mesh):
    """Placement of a tensor every rank holds whole (JAX's ``P()``)."""
    from torch.distributed.tensor import Replicate

    return [Replicate()]


def _axis(mesh, name: str):
    with set_mesh(mesh):
        return mesh_axis(name)


def local_slice(x: torch.Tensor, mesh, name: str, dim: int = 0) -> torch.Tensor:
    """This rank's contiguous slice of ``x`` along ``dim`` over the mesh
    dimension ``name`` (``torch.tensor_split`` sizes: uneven allowed)."""
    axis = _axis(mesh, name)
    if axis is None:
        return x
    lo, hi = axis.split(x.shape[dim])
    return x.narrow(dim, lo, hi - lo)


def gather_slices(x: torch.Tensor, mesh, name: str, total: int, dim: int = 0) -> torch.Tensor:
    """The inverse of ``local_slice``: the whole ``total``-long tensor on
    every rank of the dimension ``name``."""
    axis = _axis(mesh, name)
    if axis is None:
        return x
    return gather(x, axis, dim, axis.split(total)[0], total)


def batched_ep_energy(
    model: GTNMFModel,
    params: GTNMFParams,
    ys: torch.Tensor,  # (B, T)
    masks: torch.Tensor,  # (B, T) bool
    config: ep.EPConfig,
    device=None,  # None = the card; "cpu" runs the plain versions
) -> torch.Tensor:
    """Mean EP energy over a batch of signals (the port's ``ep_energy`` a
    file, with autograd)."""
    return torch.stack([ep.ep_energy(model, params, ys[b], masks[b], config, device=device)
                        for b in range(ys.shape[0])]).mean()


def init_train_state(params: GTNMFParams, optimizer, transform=None) -> dict:
    """Optimizer state for ``make_train_step``: the ``state_dict`` of
    ``optimizer`` (a factory of a ``torch.optim`` optimizer over the list of
    unconstrained leaves, e.g. ``functools.partial(torch.optim.SGD,
    lr=1e-2)``) built over ``transform``'s unconstrained parameters."""
    tf = transform if transform is not None else Transform({})
    leaves = [u.detach() for u in tf.to_unconstrained(params).values()]
    return optimizer(leaves).state_dict()


def make_train_step(
    model: GTNMFModel,
    config: ep.EPConfig,
    mesh,
    optimizer,
    transform=None,
    device=None,  # None = the card; "cpu" runs the plain versions
):
    """Distributed training step: data parallel over the mesh's ``"data"``
    dimension, autograd through the EP energy.

    ``step(params, state, ys, masks) -> (params, state, loss)``.  Each rank
    takes its contiguous slice of the B files and computes the sum of their
    energies over the global B; the loss and every gradient leaf are summed
    over ``"data"`` (one all_reduce), and every rank takes the same
    optimizer step.  The optimization runs in the unconstrained space of
    ``learn.Transform`` (log-space by default), so additive updates never
    push a variance, lengthscale or weight negative; the natural-scale
    parameters are materialized only for the energy.  Initialise ``state``
    with ``init_train_state``.
    """
    tf = transform if transform is not None else Transform({})
    axis = _axis(mesh, "data")
    dev = resolve_device(device)

    def step(params, state, ys, masks):
        B = ys.shape[0]
        ys, masks = local_slice(ys, mesh, "data"), local_slice(masks, mesh, "data")
        if ys.shape[0] == 0:
            raise ValueError(f"{B} files cannot be split over {axis.size} data ranks")
        ref = params.on(dev)
        u = {g: v.detach().clone().requires_grad_(True)
             for g, v in tf.to_unconstrained(ref).items()}
        opt = optimizer(list(u.values()))
        opt.load_state_dict(state)
        p = tf.to_params(u, ref)
        loss = sum(ep.ep_energy(model, p, y, m, config, device=dev) for y, m in zip(ys, masks)) / B
        loss.backward()
        if axis:
            flat = torch.cat([loss.detach().reshape(1)] + [x.grad.reshape(-1) for x in u.values()])
            flat = all_reduce(flat, axis)
            loss, o = flat[0], 1
            for x in u.values():
                x.grad.copy_(flat[o:o + x.numel()].reshape(x.shape))
                o += x.numel()
        opt.step()
        with torch.no_grad():
            new = tf.to_params(u, ref)
        return new, opt.state_dict(), loss.detach()

    return step


def shard_inference_over_channels(
    model: GTNMFModel,
    params: GTNMFParams,
    y: torch.Tensor,
    mesh,
    config: ep.EPConfig = ep.EPConfig(),
    device=None,  # None = the card; "cpu" runs the plain versions
):
    """Single-signal EP inference with the channels split over the mesh's
    ``"channel"`` dimension: each rank smooths its contiguous run of
    channels (K1/K2 on C_r channels on the fused backend); the ADF sweep
    and the re-site are replicated.  Every rank returns the whole result."""
    cfg = config._replace(channel_axis="channel")
    with set_mesh(mesh):
        return ep.ep_infer(model, params, y, None, cfg, device=device)


def shard_inference_over_time(
    model: GTNMFModel,
    params: GTNMFParams,
    y: torch.Tensor,
    mesh,
    config: ep.EPConfig = ep.EPConfig(),
    chunk: int = 512,
    device=None,  # None = the card; "cpu" runs the plain versions
):
    """Single-signal EP inference with the blocked scan's chunks split over
    the mesh's ``"time"`` dimension (``backend="seq"``, ``parallel=True``):
    passes 1 and 3, all the O(T) work of a later sweep, run on each rank's
    own chunks, and pass 2 exchanges the nc chunk totals, (nc, C) elements
    a pass.  The ADF sweep is replicated; the sites stay split over T
    between sweeps.  Every rank returns the whole result."""
    cfg = config._replace(parallel=True, chunk=chunk, time_axis="time")
    with set_mesh(mesh):
        return ep.ep_infer(model, params, y, None, cfg, device=device)


# ---------------------------------------------------------------------------
# Launching a world of ranks
# ---------------------------------------------------------------------------


def _rank_main(rank, fn, world, backend, root, args):
    torch.set_num_threads(1)  # the ranks share the host's cores
    if backend == "nccl":  # one GPU a rank: before any CUDA work of the rank
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method=f"file://{os.path.join(root, 'rendezvous')}",
                            rank=rank, world_size=world)
    try:
        torch.save(fn(rank, *args), os.path.join(root, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn_world(fn, world: int, backend: str, args=(), root: Optional[str] = None) -> list:
    """Run ``fn(rank, *args)`` in ``world`` new processes (``spawn``, one
    intra-op thread each) joined in one process group of ``backend``
    (``"gloo"`` when the ranks share a card or run on the CPU, ``"nccl"`` for
    one GPU a rank), with a file rendezvous in a fresh temporary directory
    under ``root``.  ``fn`` must be importable (a module-level function).
    Returns the ranks' results in rank order; a failed rank raises here.
    Under ``"nccl"`` rank r runs on GPU r, so the world needs that many
    GPUs (NCCL refuses two ranks on one GPU)."""
    import torch.multiprocessing as mp

    if backend == "nccl" and world > torch.cuda.device_count():
        raise ValueError(f"backend 'nccl' runs one GPU a rank: a world of {world} needs "
                         f"{world} GPUs, this host has {torch.cuda.device_count()}; "
                         f"use 'gloo' for ranks that share a card")

    with tempfile.TemporaryDirectory(dir=root) as d:
        mp.start_processes(_rank_main, args=(fn, world, backend, d, tuple(args)),
                           nprocs=world, start_method="spawn")
        return [torch.load(os.path.join(d, f"rank{r}.pt"), weights_only=False)
                for r in range(world)]
