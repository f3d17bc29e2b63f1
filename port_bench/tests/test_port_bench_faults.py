"""The comparison fails what it should: a run with the timed path broken
underneath (each fault the cell can have, planted in the program) comes out
not correct, and so does the control, the reference in TF32 put in the
program's place. At a small size on the CPU; the harness's look for a chip
is skipped by calling the cell's driver directly."""
import pytest

from conftest import LEARN, SEARCH, small_cell
from port_bench import harness


def correct(checks) -> bool:
    return all(c.ok for c in checks)


@pytest.mark.parametrize("workload", [SEARCH, LEARN])
def test_a_sound_run_is_correct(workload):
    out = small_cell(workload).driver.run(small_cell(workload))
    assert correct(out["checks"]), out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
@pytest.mark.parametrize("workload", [SEARCH, LEARN])
def test_a_broken_run_is_not_correct(workload, fault):
    cell = small_cell(workload)
    with cell.driver.planted(fault):
        out = cell.driver.run(cell)
    assert not correct(out["checks"]), out["checks"]


@pytest.mark.parametrize("workload", [SEARCH, LEARN])
def test_the_control_is_not_correct(workload):
    cell = small_cell(workload)
    control = cell.driver.readings(cell)["control"]
    checks = [harness.Check(k, control[k], v) for k, v in cell.driver.LIMITS.items()]
    assert not correct(checks), control
