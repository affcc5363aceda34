"""Carry model parameters across from the JAX package's artifacts.

``params_from_numpy`` takes the seven ``GTNMFParams`` leaves as numpy arrays
(e.g. ``{k: np.asarray(v) for k, v in jax_params._asdict().items()}``), with
or without a leading file axis (a stacked JAX ``GTNMFParams`` gives the port's
stacked parameters); ``load_trained`` reads a trained ``.npz`` written by
either package's ``pretrain.pipeline.save_trained`` (the keys JAX's
``pipeline.load_trained`` reads; ``full=True`` gives the ``TrainedModel`` with
its stage-1 fit), ``load_trained_batch`` a list of them as one model and
stacked parameters.  None imports jax.

Tensors are placed by ``utils.device.resolve_device``: on the card by default,
on the CPU only when asked (``device="cpu"``).
"""

from __future__ import annotations

import numpy as np
import torch

from nsgp_tpu_torch.models.gtnmf import PARAM_NAMES, GTNMFModel, GTNMFParams, stack_params
from nsgp_tpu_torch.utils.device import resolve_device


def params_from_numpy(arrays, device=None, dtype=None) -> GTNMFParams:
    """``GTNMFParams`` from a mapping of the seven leaves to arrays.

    ``dtype`` defaults to the arrays' own floating type; leaves may carry a
    leading (BF,) file axis."""
    device = resolve_device(device)
    return GTNMFParams(**{
        k: torch.as_tensor(np.array(arrays[k]), dtype=dtype, device=device)
        for k in PARAM_NAMES
    })


def load_trained(path, device=None, dtype=None, full: bool = False):
    """Load a trained artifact as ``(GTNMFModel, GTNMFParams)``; with
    ``full=True`` as ``pretrain.pipeline.TrainedModel``, its stage-1
    ``FilterbankFit`` from the ``fb_*`` keys (None on artifacts without them),
    ``normaliser`` and ``fs`` (``nsgp_tpu.pretrain.pipeline.load_trained``)."""
    device = resolve_device(device)
    with np.load(path, allow_pickle=False) as z:
        model = GTNMFModel(
            D=int(z["D"]), N=int(z["N"]),
            kernel1=str(z["kernel1"]), kernel2=str(z["kernel2"]),
            variant=str(z["variant"]), p_cubature=int(z["p_cubature"]),
        )
        params = params_from_numpy({k: z[k] for k in PARAM_NAMES}, device, dtype)
        if not full:
            return model, params
        from nsgp_tpu_torch.pretrain.pipeline import TrainedModel
        from nsgp_tpu_torch.pretrain.spectral import FilterbankFit

        t = lambda k: torch.as_tensor(np.array(z[k]), dtype=dtype, device=device)
        fit = None
        if "fb_sigma2" in z:
            sigma2 = t("fb_sigma2")
            fit = FilterbankFit(sigma2=sigma2, lam=t("fb_lam"), omega=t("fb_omega"),
                                noise=t("fb_noise"), obj=sigma2.new_zeros(()))
        return TrainedModel(
            model=model, params=params, envelopes=None, H=None, fit=fit,
            normaliser=float(z["normaliser"]) if "normaliser" in z else 1.0,
            fs=float(z["fs"]) if "fs" in z else 16000.0,
        )


def load_trained_batch(paths, device=None, dtype=None):
    """Load trained artifacts of one model structure as ``(GTNMFModel,
    paramsB)`` with the parameters stacked on a leading file axis."""
    loaded = [load_trained(p, device, dtype) for p in paths]
    model = loaded[0][0]
    for path, (m, _) in zip(paths, loaded):
        if m != model:
            raise ValueError(f"{path}: model {m} differs from {model}; a batch shares "
                             f"(D, N, kernels, variant, cubature)")
    return model, stack_params([p for _, p in loaded])
