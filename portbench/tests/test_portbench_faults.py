"""A run with the program broken underneath: every fault the cells can have
makes `correct` false (on the CPU, at a tiny width; the harness's look for a
card is skipped by running the cell on the CPU)."""

import pytest

from portbench import faults

CASES = [("tiny.uncond", f) for f in faults.SAMPLING] + [("tiny.scaffold", f) for f in faults.SAMPLING] + \
        [("tiny.train", f) for f in faults.TRAINING]


@pytest.mark.parametrize("name,fault", CASES)
def test_fault_is_not_correct(tiny, name, fault):
    with faults.planted(tiny.cell(name).traffic["generator"], fault):
        out = tiny.run(name)
    assert not out["correct"], out["checks"]
