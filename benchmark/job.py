"""What every entry point's job shares: weights, the program's model, gaps.

An entry file (``entries/<entry>.py``) defines ``Job(config, traffic, seed,
device)`` with

- ``n_inputs`` and ``samples`` (audio samples a call completes);
- ``call(i)``: the program's entry point on input ``i``, its outputs;
- ``keep(out)``: the outputs that the check compares, on the host;
- ``reference(i, ar)``: the plain reference's outputs on input ``i`` in the
  precision ``ar``, with the keys and layout of ``keep``;
- ``compare(kept, ref, i)``: the numbers compared, by name;
- ``work()``: per call, each kernel's (bytes, flops, launches) by its
  K-number and the call's ``flops``, counted from shapes.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import counts
from benchmark import reference as R

LEAVES = ("lik", "sub_var", "sub_len", "omega", "mod_var", "mod_len", "W")


def as_float32(w: dict) -> dict:
    """Hyperparameters as the program holds them (float32), in float64."""
    return {k: np.asarray(np.asarray(w[k], np.float64).astype(np.float32), np.float64)
            for k in LEAVES}


def program_model(model: dict, D: int, N: int):
    from nsgp_tpu_torch.models.gtnmf import GTNMFModel

    return GTNMFModel(D=D, N=N, kernel1=model["kernel1"], kernel2=model["kernel2"],
                      link=model["link"], variant=model["variant"],
                      p_cubature=model["p_cubature"])


def program_params(ws: list, device, dtype):
    """GTNMFParams of one file, or stacked over files when ``ws`` is a list."""
    from nsgp_tpu_torch.models.gtnmf import GTNMFParams

    stack = isinstance(ws, list)
    arrays = {k: np.stack([w[k] for w in ws]) if stack else ws[k] for k in LEAVES}
    return GTNMFParams(**{k: torch.as_tensor(v, dtype=dtype, device=device)
                          for k, v in arrays.items()})


def prior_var(ws: list, model: dict) -> torch.Tensor:
    """Each channel's prior marginal variance H Pinf H', (B, C), float64."""
    ssm = R.SSM(ws, model["kernel1"], model["kernel2"], R.F64, "cpu")
    return (ssm.H * R.F64.mv(ssm.Pinf, ssm.H)).sum(-1)


def sweep_lib(model: dict) -> str:
    """Where the reference's step-by-step sweep 1 runs: numpy on the host for
    narrow models, whose small arrays it handles with the least overhead;
    torch on the device where the sigma points times the subbands are many."""
    return "numpy" if model["sigma_points"] * model["D"] <= 4096 else "torch"


def widest(x: torch.Tensor, ref: torch.Tensor, scale, where=None) -> float:
    """max |x - ref| / scale over every element (or those ``where`` marks);
    inf where not finite."""
    gap = (x.to(torch.float64).cpu() - ref.to(torch.float64).cpu()).abs() / scale
    gap = torch.where(torch.isfinite(gap), gap, torch.full_like(gap, float("inf")))
    if where is not None:
        gap = torch.where(where, gap, torch.zeros_like(gap))
    return float(gap.max())


def nlz_gap(nlZ: torch.Tensor, ref: torch.Tensor) -> float:
    """The widest relative gap of the per-sweep energies."""
    ref = ref.to(torch.float64).cpu()
    return widest(nlZ, ref, ref.abs())


def ep_counts(T: int, BF: int, D: int, N: int, S: int, bs: int, observed: int,
              ep_itts: int, adf_kernel: str, kalman_T: int, kalman_C: int) -> dict:
    """A fused EP call: sweep 1 (K3 or K4), then the smoother (K2) after
    every sweep and the filter (K1) and an all-T re-site before each later
    one."""
    out = {adf_kernel: (*counts.adf(T, BF, D, N, S, bs, observed), 1),
           "K2": (*counts.bwd(kalman_T, kalman_C, bs), ep_itts)}
    if ep_itts > 1:
        out["K1"] = (*counts.fwd(kalman_T, kalman_C, bs), ep_itts - 1)
    flops = sum(f * n for _, f, n in out.values())
    out["flops"] = flops + (ep_itts - 1) * counts.resite_flops(D, N, S, observed)
    return out


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
