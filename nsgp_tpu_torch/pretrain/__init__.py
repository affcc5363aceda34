"""Initialization / pre-training pipeline (probSTFT fit, filterbank, GPPAD,
NMF, SE-GP fits, the legacy AR(2) filterbank)."""

from nsgp_tpu_torch.pretrain import (  # noqa: F401
    adam, ar2, filterbank, gppad, nmf, pipeline, segp, spectral)
