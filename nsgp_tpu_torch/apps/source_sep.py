"""Source separation: joint inference over stacked pre-trained models.

Port of ``nsgp_tpu/apps/source_sep.py`` (ref source_sep_piano.m): stack J
pre-trained GT-NMF models block-diagonally (``models.mixture``), run an
engine on the mixture signal, and read off per-source posterior signals.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from nsgp_tpu_torch.models import mixture
from nsgp_tpu_torch.models.gtnmf import GTNMFModel, GTNMFParams, stack_params
from nsgp_tpu_torch.utils import metrics
from nsgp_tpu_torch.utils.device import resolve_device
from nsgp_tpu_torch.utils.trace import span, spanned


class SeparationResult(NamedTuple):
    sources: torch.Tensor  # (T, J) per-source signal estimates
    snr: Optional[torch.Tensor]  # (J,) SNR vs ground-truth parts, if given
    result: object


@spanned("nsgp.separate")
def separate(
    models: Sequence[GTNMFModel],
    params: Sequence[GTNMFParams],
    y_mix: torch.Tensor,
    engine: str = "ihgp",
    true_sources: Optional[torch.Tensor] = None,  # (T, J)
    generator: Optional[torch.Generator] = None,
    n_samples: int = 20,
    mixture_lik: Optional[float] = None,
    device=None,  # None = the card; "cpu" runs the plain versions
    **engine_kwargs,
) -> SeparationResult:
    """Joint EP over the stacked model (ref source_sep_piano.m:50-145).

    ``mixture_lik``: explicit observation-noise variance for the mixture;
    defaults to the mean of the sources' trained noises.  ``generator``
    draws the Monte-Carlo read-out's noise, on its own device (default: seed
    0 on the compute device)."""
    from nsgp_tpu_torch.inference import registry

    with span("nsgp.assemble"):
        dev = resolve_device(device)
        jm, jp, slices = mixture.join_models(models, [p.on(dev) for p in params],
                                             lik=mixture_lik)
        y_mix = y_mix.to(dev)
    if engine == "ep" and engine_kwargs.get("backend") == "fused":
        # The joint model (J=3: 48 subbands + 9 modulators, 3973 ut9 sigma
        # points) goes through the batched engine at BF=1: its ADF kernel
        # streams the sigma points (config.s_chunk) and evaluates each once.
        from nsgp_tpu_torch.inference import batched as bt
        from nsgp_tpu_torch.inference.ep import EPConfig

        rb = bt.ep_infer_batch(jm, stack_params([jp]), y_mix[None], None,
                               EPConfig(**engine_kwargs), device=dev)
        # sites keeps its BF=1 axis, as in the reference package
        res = rb._replace(Eft=rb.Eft[0], Varft=rb.Varft[0], nlZ=rb.nlZ[0],
                          maxdiff=rb.maxdiff[0])
    else:
        res = registry.infer(engine, jm, jp, y_mix, None, device=dev, **engine_kwargs)

    with span("nsgp.readout"):
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        sources = mixture.source_signals(jm, jp, slices, res.Eft, res.Varft, generator,
                                         n_samples)
        snr = None
        if true_sources is not None:
            snr = metrics.snr_db(true_sources.to(dev).T, sources.T)
    return SeparationResult(sources=sources, snr=snr, result=res)
