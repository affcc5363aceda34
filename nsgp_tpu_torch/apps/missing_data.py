"""Missing-data synthesis / inpainting.

Port of ``nsgp_tpu/apps/missing_data.py`` (ref missing_data_music.m): NaN out
gap regions of the signal, run an engine, reconstruct the signal inside the
gaps from the posterior, report RMSE over gaps and SNR.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from nsgp_tpu_torch.models.gtnmf import GTNMFModel, GTNMFParams
from nsgp_tpu_torch.models.mixture import channel_contributions
from nsgp_tpu_torch.utils import metrics
from nsgp_tpu_torch.utils.device import resolve_device
from nsgp_tpu_torch.utils.trace import span, spanned


def make_gap_mask(T: int, gaps: Sequence[tuple]) -> torch.Tensor:
    """mask True = observed; gaps are (start, length) pairs
    (ref missing_data_music.m: 6 gaps of 10-320 samples).  A CPU tensor."""
    mask = torch.ones((T,), dtype=torch.bool)
    for start, length in gaps:
        mask[start:start + length] = False
    return mask


def reconstruct_signal(model: GTNMFModel, params: GTNMFParams, Eft, Varft=None,
                       generator: Optional[torch.Generator] = None, n_samples: int = 0):
    """Posterior signal estimate E[sum_d a_d z_d], (T,): the plug-in mean, or
    Monte-Carlo over the smoothed marginals (``channel_contributions``)."""
    return channel_contributions(model, params, Eft, Varft, generator, n_samples).sum(-1)


class GapFillResult(NamedTuple):
    y_hat: torch.Tensor  # (T,) reconstructed signal; (BF, T) from the batch
    rmse_gaps: torch.Tensor  # () RMSE inside the gaps; (BF,)
    snr_gaps: torch.Tensor  # () SNR (dB) inside the gaps; (BF,)
    result: object  # underlying engine result


def _child_generators(generator: Optional[torch.Generator], n: int, device):
    """One generator per file on ``device`` (the noise is drawn where the
    moments live), seeded from one parent (default: seed 0)."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    seeds = torch.randint(0, 2**62, (n,), generator=generator, device=generator.device)
    return [torch.Generator(device=device).manual_seed(int(s)) for s in seeds]


@spanned("nsgp.fill_gaps_batch")
def fill_gaps_batch(
    model: GTNMFModel,
    paramsB: GTNMFParams,  # buffers with a leading (BF,) file axis
    y_trueB: torch.Tensor,  # (BF, T) clean signals
    maskB: torch.Tensor,  # (BF, T) True = observed
    engine: str = "ep",
    generator: Optional[torch.Generator] = None,
    n_samples: int = 20,
    metric_gapsB: Optional[torch.Tensor] = None,
    device=None,  # None = the card; "cpu" runs the plain versions
    **engine_kwargs,
) -> GapFillResult:
    """Batched ``fill_gaps``: BF files through one batched inference
    (``inference.batched``).  Returns per-file metric tensors (BF,).  The
    result holds moments, sites and energies only: a GIEKF result's dense
    state trajectories ``ms`` / ``Ps`` are dropped (None), as in the JAX
    package (about 0.7 GB a file in float32 at music length)."""
    from nsgp_tpu_torch.inference import batched as bt

    with span("nsgp.assemble"):
        dev = resolve_device(device)
        paramsB = paramsB.on(dev)
        y_trueB, maskB = y_trueB.to(dev), maskB.to(dev)
        y_obsB = torch.where(maskB, y_trueB, torch.full_like(y_trueB, float("nan")))
    res = bt.infer_batch(engine, model, paramsB, y_obsB, maskB, device=dev, **engine_kwargs)

    with span("nsgp.readout"):
        BF = y_trueB.shape[0]
        gens = _child_generators(generator, BF, dev)
        y_hatB = torch.stack([
            reconstruct_signal(model, paramsB.select(b), res.Eft[b], res.Varft[b], gens[b],
                               n_samples)
            for b in range(BF)])
        gapB = ~maskB if metric_gapsB is None else metric_gapsB.to(dev)
        if hasattr(res, "ms") and hasattr(res, "Ps"):
            res = res._replace(ms=None, Ps=None)
        return GapFillResult(y_hat=y_hatB, rmse_gaps=metrics.rmse(y_trueB, y_hatB, gapB),
                             snr_gaps=metrics.snr_db(y_trueB, y_hatB, gapB), result=res)


def fill_gaps(
    model: GTNMFModel,
    params: GTNMFParams,
    y_true: torch.Tensor,  # clean signal (ground truth for metrics)
    mask: torch.Tensor,  # True = observed
    engine: str = "ep",
    generator: Optional[torch.Generator] = None,
    n_samples: int = 20,
    metric_gaps: Optional[torch.Tensor] = None,  # True = score here; default ~mask
    device=None,  # None = the card; "cpu" runs the plain versions
    **engine_kwargs,
) -> GapFillResult:
    """Run inference with masked observations and score the reconstruction
    (ref missing_data_music.m:119-175).  ``metric_gaps`` separates the scored
    region from the observation mask: padding to a uniform length is
    unobserved but must not count as a gap."""
    from nsgp_tpu_torch.inference import registry

    dev = resolve_device(device)
    params = params.on(dev)
    y_true, mask = y_true.to(dev), mask.to(dev)
    y_obs = torch.where(mask, y_true, torch.full_like(y_true, float("nan")))
    res = registry.infer(engine, model, params, y_obs, mask, device=dev, **engine_kwargs)

    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    y_hat = reconstruct_signal(model, params, res.Eft, res.Varft, generator, n_samples)
    gap = ~mask if metric_gaps is None else metric_gaps.to(dev)
    return GapFillResult(y_hat=y_hat, rmse_gaps=metrics.rmse(y_true, y_hat, gap),
                         snr_gaps=metrics.snr_db(y_true, y_hat, gap), result=res)
