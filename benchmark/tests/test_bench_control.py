"""The check fails what it should, at a tiny size on the CPU: each control
(the reference in bfloat16 in the program's place: the whole frame, and
the draw alone) and each fault a cell can have, planted under the timed
path while the rest of a run goes on as on the card."""

import pytest

from benchmark import check, faults, harness
from conftest import CELLS, tiny

SEED = 2 ** 31 + 3


@pytest.mark.parametrize("name", CELLS)
def test_controls_are_not_correct(name):
    c = tiny(name)
    _, numbers, ctl = harness.run(c, SEED, 0.2, False, 0.0, device="cpu",
                                  controls=("bf16", "draw-bf16"))
    assert check.verdict(numbers, c.limits)[0]
    for kind, nums in ctl.items():
        ok, checks = check.verdict(nums, c.limits)
        assert not ok, (kind, checks)


@pytest.mark.parametrize("name,fault", [
    (name, fault) for name in CELLS for fault in faults.for_cell(tiny(name))])
def test_a_fault_under_the_timed_path_is_not_correct(name, fault):
    undo = faults.plant(fault)
    try:
        result, _, _ = harness.run(tiny(name), SEED, 0.2, False, 0.0,
                                   device="cpu")
    finally:
        undo()
    assert not result["correct"], result["checks"]
