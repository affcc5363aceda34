"""nsgp_tpu_torch — PyTorch/CUDA port of ``nsgp_tpu`` (GT-NMF Power-EP).

The JAX package ``nsgp_tpu`` is the reference; this package mirrors its
layout and names module for module, so each counterpart is found at the
same path:

- ``ops``       : cubature rules, kernels -> state space, block SSM assembly,
                  moment matching, the sequential Kalman engine, the blocked
                  and log-depth scans, the DARE bank (``ops.dare``), and the
                  hand-written CUDA kernels of the fused filter/smoother
                  (``ops.fused_kalman``, sources under ``csrc/``).
- ``models``    : the GT-NMF model and its parameters (an ``nn.Module``),
                  stacked per-file parameters, joint mixture models.
- ``inference`` : Power-EP (``ep_infer``), sequential and fused backends;
                  steady-state IHGP (``ihgp_infer``, ``ihgp_energy``); batched
                  EP and IHGP over files (``ep_infer_batch``,
                  ``ihgp_infer_batch``), GIEKF (one file and batched);
                  learning and HMC/VI; the engine registry.
- ``pretrain``  : a trained model from a raw signal
                  (``pipeline.train_gtnmf_fixed_params``): the Whittle fit of
                  the spectral-mixture filterbank, the steady Kalman
                  filterbank, GPPAD, NMF, SE-GP fits; the AR(2) filterbank.
- ``apps``      : missing-data synthesis (``fill_gaps``, ``fill_gaps_batch``),
                  source separation (``separate``), denoising (``denoise``,
                  ``tv_wiener``).
- ``utils``     : full-fp32 matmul guard, device rule, RMSE / SNR /
                  log-spectral SNR, fwSegSNR and STOI, WAV IO.
- ``parallel``  : the device mesh over ``torch.distributed``: EP split by
                  channel or by time over ranks, data-parallel training
                  (imported on its own, not by this package).
- ``convert``   : parameters from numpy / trained ``.npz`` artifacts.
- ``experiments``: the paper's experiment drivers and their CLIs
                  (``python -m nsgp_tpu_torch.experiments.<name>``), imported
                  on their own, not by this package.

It imports torch and numpy only, never jax.  Kernels are compiled with
``nvcc`` at first use on a CUDA tensor, never at import.  Entry points place
their work on the card unless the caller passes ``device="cpu"``
(``utils.device``).
"""

__version__ = "0.1.0"

from nsgp_tpu_torch import apps, inference, models, ops, pretrain, utils  # noqa: F401
