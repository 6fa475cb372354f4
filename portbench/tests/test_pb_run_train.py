"""Whole runs of the train cells on the CPU (portbench/tests/pb_cases.py)."""

import pytest

from portbench.tests import pb_cases as pc

CELLS = pc.cells_of("train", "classify")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return pc.make_root(tmp_path_factory)


@pytest.mark.parametrize("cell", CELLS)
def test_program_within_the_cells_limits(root, cell):
    pc.program_within_limits(root, cell)


@pytest.mark.parametrize("cell,fault", pc.fault_cases("train", "classify"))
def test_a_planted_fault_is_not_correct(root, cell, fault):
    pc.fault_not_correct(root, cell, fault)


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(root, cell):
    pc.control_not_correct(root, cell)
