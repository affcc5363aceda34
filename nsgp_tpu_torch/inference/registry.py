"""Engine registry: one dispatch point for the inference engines.

Port of ``nsgp_tpu/inference/registry.py``.  Applications select an engine
by name.  Only ``"ep"`` is ported; ``"ihgp"`` (ROADMAP Queue 1 item 12) and
``"giekf"`` (item 13) raise ``NotImplementedError``.  ``energy`` waits for
``ep_energy`` (item 8).
"""

from __future__ import annotations

ENGINES = ("ep", "ihgp", "giekf")
_UNPORTED = {"ihgp": "ROADMAP Queue 1 item 12 (ops/dare.py, inference/ihgp.py)",
             "giekf": "ROADMAP Queue 1 item 13 (inference/giekf.py)"}


def get_engine(name: str):
    """Returns (infer_fn, energy_fn, config_cls) for an engine name;
    ``energy_fn`` is None until the engine's energy is ported."""
    if name == "ep":
        from nsgp_tpu_torch.inference import ep

        return ep.ep_infer, None, ep.EPConfig
    if name in _UNPORTED:
        raise NotImplementedError(f"engine {name!r} is not ported yet: {_UNPORTED[name]}")
    raise ValueError(f"unknown engine {name!r}; expected one of {ENGINES}")


def infer(engine: str, model, params, y, mask=None, config=None, device=None, **cfg_kwargs):
    """Run posterior inference with the named engine.

    ``config`` takes precedence; otherwise a config is built from
    ``cfg_kwargs`` (empty = engine defaults).  Returns the engine's result
    (all carry .Eft / .Varft / .nlZ / .sites)."""
    infer_fn, _, config_cls = get_engine(engine)
    cfg = config if config is not None else config_cls(**cfg_kwargs)
    return infer_fn(model, params, y, mask, cfg, device=device)
