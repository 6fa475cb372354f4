"""Shared cases of the whole-run tests (test_pb_run_*.py): a whole run of
a cell on the CPU, the program's plain kernels standing in for K1 and
K2; the program against the reference within the cell's own limits; the
control and each fault planted in the timed path not correct."""

import json

import torch

from portbench import check, drivers, faults, run as run_mod
from portbench.readings import reading
from portbench.tests.pb_small import ROOT, small_root

SEED = 2 ** 31 + 11      # above 32 signed bits, as the driver's seeds are


def make_root(tmp_path_factory):
    torch.set_num_threads(2)
    return small_root(tmp_path_factory.mktemp("checkout"))


def limits(cell):
    return check.load_limits(ROOT, cell)


def driver(cell):
    """The Driver class of a cell's traffic."""
    return drivers.load(run_mod.load_cell(ROOT, cell)[3]["driver"])


def program_within_limits(root, cell):
    result, notes = run_mod.run(root, cell, SEED, 1.5, False, device="cpu",
                                limits=limits(cell))
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
    assert set(result) == {"correct", "attempted", "failed", "metrics",
                           "device", "checks"}
    assert set(result["metrics"]) == {"setup_s", driver(cell).RATE}
    assert set(result["checks"]) == set(limits(cell))
    assert result["attempted"] > 0 and result["failed"] == 0
    assert notes[-1].startswith("check ")
    json.dumps(result)


def fault_not_correct(root, cell, fault):
    result, _ = run_mod.run(root, cell, SEED, 1.5, False, device="cpu",
                            wrap=faults.FAULTS[fault], limits=limits(cell))
    assert not result["correct"], result["checks"]
    assert result["failed"] > 0


def control_not_correct(root, cell):
    _, _, config, tr = run_mod.load_cell(root, cell)
    numbers = reading(config, tr, SEED, "cpu", "control", 1.5)
    checks = check.verdict(numbers, limits(cell))
    assert not check.is_correct(checks), checks


def cells_of(*names):
    """The cells whose traffic names one of these drivers."""
    from portbench.tests.pb_small import bench
    return sorted(w["name"] for w in bench()["workloads"]
                  if run_mod.load_cell(ROOT, w["name"])[3]["driver"] in names)


def fault_cases(*names):
    return [(cell, fault) for cell in cells_of(*names)
            for fault in driver(cell).FAULTS]
