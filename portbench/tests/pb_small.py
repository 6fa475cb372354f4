"""A checkout in miniature for the CPU tests: the cells of BENCHMARK.json
at their full widths on 64x64 images and small batches (each driver's
``SMALL``), with the real drivers and metric readers. The tests pass each
cell's real limits. (At WIDTH 0.25 the int8 control's errors fall under
the cells' limits: it keeps too few channels to average its rounding.)"""

from __future__ import annotations

import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SIZE = 64


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def config(name):
    """The configuration file ``portbench/configs/<name>.json``."""
    with open(os.path.join(ROOT, "portbench", "configs", f"{name}.json")) as f:
        return json.load(f)


def small_root(tmp_path):
    """A root holding BENCHMARK.json and every configuration and traffic
    cut to the CPU's size."""
    from portbench import drivers
    b = bench()
    for sub in ("configs", "traffic"):
        (tmp_path / "portbench" / sub).mkdir(parents=True, exist_ok=True)
    for c in b["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cf = json.load(f)
        if "cfg" in cf:
            cf["cfg"]["MODEL"].update(COMPUTE_DTYPE="float32")
            cf["cfg"]["TRAIN"]["IMGSIZE"] = cf["cfg"]["TEST"]["IMGSIZE"] = SIZE
        else:
            cf["compute_dtype"] = "float32"
        (tmp_path / c["file"]).write_text(json.dumps(cf))
    for w in b["workloads"]:
        with open(os.path.join(ROOT, "portbench", "traffic",
                               f"{w['traffic']}.json")) as f:
            tr = json.load(f)
        tr.update(drivers.load(tr["driver"]).SMALL)
        (tmp_path / "portbench" / "traffic" /
         f"{w['traffic']}.json").write_text(json.dumps(tr))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    return str(tmp_path)
