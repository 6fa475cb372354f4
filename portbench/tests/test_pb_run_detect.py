"""Whole runs of the detect cells on the CPU (portbench/tests/pb_cases.py)."""

import pytest

from portbench.tests import pb_cases as pc

CELLS = pc.cells_of("detect")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return pc.make_root(tmp_path_factory)


@pytest.mark.parametrize("cell", CELLS)
def test_program_within_the_cells_limits(root, cell):
    pc.program_within_limits(root, cell)


@pytest.mark.parametrize("cell,fault", pc.fault_cases("detect"))
def test_a_planted_fault_is_not_correct(root, cell, fault):
    pc.fault_not_correct(root, cell, fault)


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(root, cell):
    pc.control_not_correct(root, cell)


def test_traced_line(root):
    from portbench import run as run_mod
    cell = CELLS[0]
    result, _ = run_mod.run(root, cell, pc.SEED, 1.5, True, device="cpu",
                            limits=pc.limits(cell))
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert len(result["breakdown"]["idle_gaps"]) <= 10
    assert list(result)[-1] == "checks"
    # no device on the CPU: what reads the device trace reports nothing
    assert "eager_ms.detect" not in result["metrics"]
    assert "k2_roofline" not in result["metrics"]
    assert "predictor.dispatch_host_ms.detect" in result["metrics"]
