"""Inference engines: Power-EP, single-file and batched, and the registry."""

from nsgp_tpu_torch.inference import batched, ep, registry  # noqa: F401
