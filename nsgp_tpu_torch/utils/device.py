"""Where the port's entry points place their work.

The rule: the card unless the caller asks for the CPU.  ``device=None``
means ``torch.device("cuda")``; without a CUDA device that raises, it never
falls back to the CPU quietly.  ``"cpu"`` (or any explicit device) is
honoured as given; the tests pass it.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> the card (``RuntimeError`` without one); else as asked."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the card by default; pass "
                "device='cpu' to run the plain versions on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def place_inputs(params, y: torch.Tensor, mask, device=None):
    """One signal's inputs on the device asked for (``resolve_device``):
    (device, params there, y there with NaNs zeroed in the parameters'
    dtype, mask there, default ~isnan(y))."""
    dev = resolve_device(device)
    params = params.on(dev)
    y = y.to(dev)
    mask = ~torch.isnan(y) if mask is None else mask.to(dev, torch.bool)
    return dev, params, torch.nan_to_num(y).to(params.sub_var.dtype), mask
