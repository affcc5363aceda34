"""Paper experiment drivers (the reference's matlab/experiments layer).

Port of ``nsgp_tpu/experiments``: one module per experiment, each with a
``run(...)`` returning the JAX package's plain-dict results table key for key
and a ``main()`` CLI with the same flags, run as
``python -m nsgp_tpu_torch.experiments.<name>``:

- synthetic         : 3-engine RMSE comparison on a prior sample
                      (synthetic_data_experiment.m:242-253)
- toy_demo          : EP at the true hyperparameters on a toy prior sample
- train_corpus      : corpus pre-training (train_speech.m / train_music.m)
- missing_data      : gap-filling on music/speech, engines x ep_itts, RMSE/SNR
                      over the gaps (missing_data_music.m:119-175), serial or
                      batched over files
- train_hyperopt    : hyperparameter learning on the ADF energy, then the
                      missing-data protocol with init vs learned hypers
- denoising         : white-noise sweep on speech (noise_reduction_speech.m)
- source_sep        : 3-note joint separation (source_sep_piano.m)
- textures_ihgp     : long-signal texture gap-filling with IHGP
- nonstationary_demo: the three engines on 1 s of speech
- filterbank_demo   : the stationary probabilistic filterbank
- hmc_hypers, hmc_sbc: HMC/VI over hyperparameters and its calibration
- scaling_dryrun    : EP split by time and by channel over a world of ranks
                      (``parallel.mesh``): parity, collectives and bytes
- figures           : the paper figures' data (on the device) and PNGs
- speech_fit_probe  : the weak speech files' fit variations, selected on
                      validation gaps

Devices: ``--device cuda`` (the default) or ``cpu``; the default raises
without a card (``utils.device.resolve_device``).  The working type is
float32 on the card and float64 on the CPU, as the JAX package runs float32
on the TPU and float64 (x64) on the CPU.  Random inputs come from a
``torch.Generator`` seeded from ``seed`` and can be given instead (the
``W=``, ``sample=``, ``noise=`` arguments).

Outputs: every CLI writes under ``results/torch/`` (JSON and trained
artifacts), never over the JAX package's committed files under
``results/``; the drivers read the committed ``results/trained/`` models.
"""

from __future__ import annotations

import torch

AUDIO_ROOT = "/root/reference/audio"
OUT_ROOT = "results/torch"  # every CLI's JSON
TRAINED_ROOT = "results/trained"  # the committed trained models (read)
TRAINED_OUT = "results/torch/trained"  # models this package trains (written)


def working_dtype(dev: torch.device) -> torch.dtype:
    """float32 on the card, float64 elsewhere."""
    return torch.float32 if dev.type == "cuda" else torch.float64


def sync(dev: torch.device) -> None:
    """Wait for the card before a clock is read."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def add_device_arg(ap) -> None:
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])


def with_lik(params, lik: float):
    """A copy of ``params`` whose noise variance is ``lik`` (in the
    parameters' dtype, on their device): JAX's ``params._replace(lik=...)``."""
    from nsgp_tpu_torch.models.gtnmf import GTNMFParams

    leaves = params.leaves()
    return GTNMFParams(torch.tensor(lik, dtype=leaves[0].dtype, device=leaves[0].device),
                       *leaves[1:])
