"""CUDA kernels the device ran in a call, from the traced segment."""


def read(tr):
    return len(tr.kernels) / tr.calls if tr.kernels else None
