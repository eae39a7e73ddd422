"""The control comes out not correct: the reference put in the program's
place one precision lower (every stage's output in bfloat16, against the
float32 the configuration states) fails the cell's limits.

On the CPU at tiny boxes; on the card (marked `cuda`) at the cell's own size,
one seed (`calibrate.py` reads three or more for the limits).
"""

import pytest
from conftest import SEED, TINY

from harness import cells, compare, reference

WORKLOADS = ["latest-dawn", "simple-eor"]


def _control_readings(workload, dev, overrides):
    cell = cells.resolve(workload)
    ref_ics = reference.initial_conditions(cell, SEED, dev, overrides)
    ctl_ics = reference.initial_conditions(cell, SEED, dev, overrides, precision="bfloat16")
    readings = {"ics": compare.ics_reading(ctl_ics, ref_ics)}
    ref = reference.cone(cell, SEED, ref_ics, dev, overrides)
    del ref_ics
    ctl = reference.cone(cell, SEED, ctl_ics, dev, overrides, precision="bfloat16")
    readings.update(compare.cone_readings(ctl, ref))
    return cell, readings


@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_fails_the_limits_on_the_cpu(workload):
    import torch

    cell, readings = _control_readings(workload, torch.device("cpu"),
                                       TINY[cells.resolve(workload).config_name])
    ok, checks = compare.judge(readings, cell.limits)
    assert not ok
    failed = [k for k, c in checks.items() if c["value"] > c["limit"]]
    assert len(failed) >= len(checks) // 2, checks


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_fails_every_limit_on_the_card(workload, cuda_device):
    cell, readings = _control_readings(workload, cuda_device, None)
    ok, checks = compare.judge(readings, cell.limits)
    assert not ok
    assert all(c["value"] > c["limit"] for c in checks.values()), checks
