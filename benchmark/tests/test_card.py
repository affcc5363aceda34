"""On the card: each cell at a small size runs through the harness and comes
out correct, and the traced segment reads per-layer metrics.  Run there with
``python -m pytest -m cuda benchmark/tests/test_card.py``; skipped without a
CUDA device."""

import time

import pytest

from benchmark import run
from benchmark.manifest import Manifest
from benchmark.tests.small import OVERRIDES


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from nsgp_tpu_torch.ops import _build

    _build.library()
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(OVERRIDES))
def test_cell_on_the_card(cell, card):
    man = Manifest()
    r = run.run_cell(man, cell, 2**31 + 3, 0.5, True, card, time.time(), OVERRIDES[cell])
    assert r["correct"], r["checks"]
    kernels = [v["value"] for k, v in r["metrics"].items() if k.split(".")[0] == "kernels_per_call"]
    assert r["trace"]["busy_s"] > 0 and kernels and kernels[0] > 0
