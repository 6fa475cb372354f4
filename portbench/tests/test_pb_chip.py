"""On the card, at each cell's own size: the control reads above the
cell's limits on three seeds (portbench/readings.py; the card's runs of
PERF.md set the limits from these readings). Skips without a card."""

import pytest

from portbench import check
from portbench.readings import reading
from portbench.run import load_cell
from portbench.tests.pb_small import ROOT, bench

CELLS = sorted(w["name"] for w in bench()["workloads"])


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.chip
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_the_cells_size(card, cell):
    _, _, config, traffic = load_cell(ROOT, cell)
    limits = check.load_limits(ROOT, cell)
    for seed in (101, 102, 103):
        numbers = reading(config, traffic, seed, card, "control", 1.0)
        assert not check.is_correct(check.verdict(numbers, limits))
