"""The check's control: the reference computed in bfloat16, the nearest
precision below the configurations' float32, put in the program's place,
comes out not correct against each cell's limits. On the CPU at each
cell's small stand-in; on the card (marked ``chip``) at the cell's own
size, on three seeds."""

from __future__ import annotations

import pytest

from ptbench import calibrate, check, harness
from ptbench.tests import cells


@pytest.mark.parametrize("workload", sorted(cells.SMALL))
def test_control_fails_the_limits_on_the_cpu(workload):
    parts = cells.small_parts(workload)
    lines = list(calibrate.readings(parts, 2, [3], [3, 4, 2**31 + 1], "cpu"))
    limits = parts["check"]["limits"]
    assert all(check.judge(r, limits) for r in lines if r["side"] == "program")
    control = [r for r in lines if r["side"] == "control"]
    assert len(control) == 3 and not any(check.judge(r, limits) for r in control)


@pytest.mark.chip
@pytest.mark.parametrize("workload", ["rtiow_1080p.pool", "knot70k_1080p.pool",
                                      "rtiow_1080p.wave"])
def test_control_fails_the_limits_on_the_card(workload, cuda_device):
    parts = harness.cell_parts(cells.spec(), workload)
    lines = list(calibrate.readings(parts, 1, [], [101, 202, 303], cuda_device))
    assert len(lines) == 3
    assert not any(check.judge(r, parts["check"]["limits"]) for r in lines)
