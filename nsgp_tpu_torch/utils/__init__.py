"""Utilities: matmul-precision guard, device rule, metrics."""

from nsgp_tpu_torch.utils import device, metrics, precision  # noqa: F401
