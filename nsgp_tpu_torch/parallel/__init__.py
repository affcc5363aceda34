"""Mesh parallelism over torch.distributed (data / channel / time axes)."""
