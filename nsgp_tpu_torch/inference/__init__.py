"""Inference engines: Power-EP and IHGP, single-file and batched, GIEKF,
learning and HMC/VI, and the registry."""

from nsgp_tpu_torch.inference import batched, ep, ihgp, registry  # noqa: F401
