"""Numerics substrate: cubature, kernels->SS, block SSM, moments, Kalman,
the DARE bank, and the fused CUDA passes (``fused_kalman``, built at first
use)."""

from nsgp_tpu_torch.ops import cubature, dare, fused_kalman, kalman, kernels, moments, ssm  # noqa: F401
