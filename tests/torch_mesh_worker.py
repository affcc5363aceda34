"""The ranks of the gloo worlds that ``tests/test_torch_mesh.py`` spawns.

A rank imports this module and the port only (no jax): each case builds its
mesh (every rank takes part), runs the sharded call on the CPU in float64 and
returns numpy arrays, or None on a rank outside the case's mesh.
"""

import contextlib
import functools

import numpy as np
import torch

from nsgp_tpu_torch.convert import params_from_numpy
from nsgp_tpu_torch.inference import ep
from nsgp_tpu_torch.inference.learn import GROUPS, Transform
from nsgp_tpu_torch.models.gtnmf import GTNMFModel
from nsgp_tpu_torch.parallel import collectives
from nsgp_tpu_torch.parallel import mesh as pmesh

FIELDS = ("Eft", "Varft", "lZ", "nlZ", "ms", "Ps", "maxdiff")


def toy(arrays: dict):
    """The toy model of tests/test_mesh.py (D=6, N=2, C=8, p_cubature=7) with
    the given parameter arrays, float64 on the CPU."""
    D, N = arrays["W"].shape
    model = GTNMFModel(D=D, N=N, kernel1="matern32", kernel2="matern52", p_cubature=7)
    return model, params_from_numpy(arrays, device="cpu", dtype=torch.float64)


def result_arrays(r) -> dict:
    out = {f: getattr(r, f).numpy() for f in FIELDS}
    out["ttau"], out["tnu"] = r.sites.ttau.numpy(), r.sites.tnu.numpy()
    return out


def energy_and_grad(model, params, ys, masks, cfg, mesh=None):
    """batched_ep_energy and its gradient over the unconstrained leaves
    (learn.GROUPS order), under ``mesh`` when given."""
    tf = Transform({})
    u = {g: v.detach().clone().requires_grad_(True)
         for g, v in tf.to_unconstrained(params).items()}
    with pmesh.set_mesh(mesh) if mesh is not None else contextlib.nullcontext():
        e = pmesh.batched_ep_energy(model, tf.to_params(u, params), torch.tensor(ys),
                                    torch.tensor(masks), cfg, device="cpu")
        e.backward()
        e = e.detach()
    return e.item(), np.concatenate([u[g].grad.numpy().ravel() for g in GROUPS])


def train_step(model, params, ys, masks, cfg, mesh, lr):
    sgd = functools.partial(torch.optim.SGD, lr=lr)
    step = pmesh.make_train_step(model, cfg, mesh, sgd, device="cpu")
    p2, _, loss = step(params, pmesh.init_train_state(params, sgd), torch.tensor(ys),
                       torch.tensor(masks))
    return {g: getattr(p2, g).numpy() for g in GROUPS}, float(loss)


def run_case(case: dict):
    model, params = toy(case["params"])
    cfg = ep.EPConfig(**case.get("config", {}))
    mesh = pmesh.make_mesh(case["mesh"], "cpu")
    if mesh is None:
        return None
    collectives.reset_collectives()
    kind = case["kind"]
    if kind == "channel":
        r = pmesh.shard_inference_over_channels(model, params, torch.tensor(case["y"]), mesh,
                                                cfg, device="cpu")
        out = result_arrays(r)
    elif kind == "time":
        r = pmesh.shard_inference_over_time(model, params, torch.tensor(case["y"]), mesh, cfg,
                                            chunk=case["chunk"], device="cpu")
        out = result_arrays(r)
    elif kind == "2d":
        with pmesh.set_mesh(mesh):
            r = ep.ep_infer(model, params, torch.tensor(case["y"]), None,
                            cfg._replace(time_axis="time", channel_axis="channel"), device="cpu")
        out = result_arrays(r)
    elif kind == "slices":
        x = torch.arange(case["n"] * 2, dtype=torch.float64).reshape(case["n"], 2)
        own = pmesh.local_slice(x, mesh, "data")
        out = dict(own=own.numpy(), whole=pmesh.gather_slices(own, mesh, "data", case["n"]).numpy())
    elif kind == "energy":
        out = dict(zip(("loss", "grad"), energy_and_grad(
            model, params, case["ys"], case["masks"], cfg._replace(channel_axis="channel"),
            mesh)))
    else:  # "train"
        out = dict(zip(("params", "loss"), train_step(model, params, case["ys"], case["masks"],
                                                      cfg, mesh, case["lr"])))
    out["collectives"] = collectives.collective_stats()
    return out


def run_cases(rank: int, cases: dict) -> dict:
    """Every case in turn, on every rank of the world."""
    return {name: run_case(case) for name, case in cases.items()}
