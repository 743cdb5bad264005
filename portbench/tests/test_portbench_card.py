"""On the card, at the cells' own sizes: the control (the plain reference in
the program's place, computed in TF32) comes out not correct, and the
program comes out correct, for a sampling and the training cell.

Marked `cuda`; each test skips where torch sees no CUDA device (decided
inside the test). On a machine with a card, from the root of the repository:
    python -m pytest portbench/tests/test_portbench_card.py -m cuda -q
"""

import time

import pytest
import torch

from portbench.harness import registry, runner

pytestmark = pytest.mark.cuda

CELLS = ["genie2-base.uncond-l256-b4", "genie2-base.train-l256-b4"]


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(device, name):
    out = runner.run(registry.find_cell(name), 3000000301, 2.0, False, device, time.perf_counter(), program="control")
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_program_is_correct(device, name):
    out = runner.run(registry.find_cell(name), 3000000302, 2.0, False, device, time.perf_counter())
    assert out["correct"], out["checks"]
