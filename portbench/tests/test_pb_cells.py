"""Every cell of BENCHMARK.json resolves to its files by name, and the
file keeps to the shape the benchmark's contract gives it."""

import json
import os
import re

import pytest
import torch

from portbench import drivers, faults, reference
from portbench.tests.pb_small import ROOT, bench

B = bench()
CELLS = [w["name"] for w in B["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _load(*parts):
    with open(os.path.join(ROOT, *parts)) as f:
        return json.load(f)


def test_top_level_keys():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert B["paths"] == ["portbench"]
    assert all(not w.startswith("/") and ".." not in w
               for w in B["command"])
    assert 1 <= B["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 * 1024


def test_names_units_and_entry_keys():
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in B["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in B["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in B["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
    everything = B["configs"] + B["workloads"] + B["end_to_end"] + \
        B["per_layer"]
    assert all(NAME.match(x["name"]) for x in everything)
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in B[group]]
        assert len(names) == len(set(names))
    assert all(re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
               for m in B["end_to_end"] + B["per_layer"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    w = next(x for x in B["workloads"] if x["name"] == cell)
    config = next(c for c in B["configs"] if c["name"] == w["config"])
    cf = _load(config["file"])
    assert cf["name"] == config["name"] and cf["source"] == config["source"]
    assert cf["reduced"] == config["reduced"]
    traffic = _load("portbench", "traffic", f"{w['traffic']}.json")
    driver = drivers.load(traffic["driver"])
    assert set(driver.FAULTS) <= set(faults.FAULTS)
    limits = _load("portbench", "limits", f"{cell}.json")
    assert all(v["limit"] > 0 for v in limits.values())
    e2e = [m["name"] for m in B["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    assert "setup_s" in e2e and driver.RATE in e2e
    assert len(e2e) >= 2
    layer = [m for m in B["per_layer"]
             if cell in m.get("workloads", [cell])]
    assert layer and all(m["moves"] in e2e for m in layer)
    for m in layer:
        assert os.path.exists(os.path.join(ROOT, "portbench", "metrics",
                                           f"{m['name']}.py"))


def test_each_metric_lists_cells_that_report_what_it_moves():
    e2e = {m["name"]: m for m in B["end_to_end"]}
    for m in B["per_layer"]:
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", CELLS))


@pytest.mark.parametrize("name", [c["name"] for c in B["configs"]])
def test_config_names_a_reference_that_meets_the_contract(name):
    entry = next(c for c in B["configs"] if c["name"] == name)
    cf = _load(entry["file"])
    mod = reference.module(cf)
    assert os.path.samefile(mod.__file__, os.path.join(ROOT, cf["reference"]))
    assert all(callable(getattr(mod, f)) for f in reference.CONTRACT)
    with torch.device("meta"):
        model = reference.build(cf)
    if "parameters" in cf:
        assert sum(p.numel() for p in model.parameters()) == cf["parameters"]


def test_every_config_is_used():
    used = {w["config"] for w in B["workloads"]}
    assert used == {c["name"] for c in B["configs"]}
