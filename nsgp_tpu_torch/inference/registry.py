"""Engine registry: one dispatch point for the inference engines.

Port of ``nsgp_tpu/inference/registry.py``.  Applications select an engine
by name: ``"ep"``, ``"ihgp"`` and ``"giekf"``.
"""

from __future__ import annotations

ENGINES = ("ep", "ihgp", "giekf")


def get_engine(name: str):
    """Returns (infer_fn, energy_fn, config_cls) for an engine name."""
    if name == "ep":
        from nsgp_tpu_torch.inference import ep

        return ep.ep_infer, ep.ep_energy, ep.EPConfig
    if name == "ihgp":
        from nsgp_tpu_torch.inference import ihgp

        return ihgp.ihgp_infer, ihgp.ihgp_energy, ihgp.IHGPConfig
    if name == "giekf":
        from nsgp_tpu_torch.inference import giekf

        return giekf.giekf_infer, giekf.giekf_energy, giekf.GIEKFConfig
    raise ValueError(f"unknown engine {name!r}; expected one of {ENGINES}")


def _config(config_cls, config, cfg_kwargs):
    return config if config is not None else config_cls(**cfg_kwargs)


def infer(engine: str, model, params, y, mask=None, config=None, device=None, **cfg_kwargs):
    """Run posterior inference with the named engine.

    ``config`` takes precedence; otherwise a config is built from
    ``cfg_kwargs`` (empty = engine defaults).  Returns the engine's result
    (all carry .Eft / .Varft)."""
    infer_fn, _, config_cls = get_engine(engine)
    return infer_fn(model, params, y, mask, _config(config_cls, config, cfg_kwargs),
                    device=device)


def energy(engine: str, model, params, y, mask=None, config=None, device=None, **cfg_kwargs):
    """Marginal-likelihood energy of the named engine (autograd-ready), with
    the config rule of ``infer``."""
    _, energy_fn, config_cls = get_engine(engine)
    return energy_fn(model, params, y, mask, _config(config_cls, config, cfg_kwargs),
                     device=device)
