"""The model comes from the module that a configuration's ``reference``
names (portbench/reference/__init__.py): what is measured is what it was
when every caller imported portbench/reference/model.py itself, each part
of the harness goes through the named module, and a configuration that
names none, or one outside portbench/ or short of the contract, is
refused."""

import hashlib
import json
import os

import pytest
import torch

from portbench import counts, reference, weights
from portbench import run as run_mod
from portbench.tests import pb_cases as pc
from portbench.tests import pb_ref_alias
from portbench.tests.pb_small import config as _config

ALIAS = "portbench/tests/pb_ref_alias.py"
# the counts, and sha256 over make_weights at width and depth 0.25 on
# SEED, before and after calibrate on detect_pool's first 64x64 batch of
# 2, that the harness gave when its callers imported model.build directly
FLOPS = {"yolov4-608": (608, 134422398976.0),
         "cspdarknet53-256": (256, 13065256960.0)}
WEIGHTS = {
    "yolov4-608": (
        "4b776f4022f60a767b458d02eb4ee30bc1b31cf9230ebf89de6f2b3b0af1cd0e",
        "355130c9a09d376e671b151ebc01038883b688817583e767dce4b0f32f8a359f"),
    "cspdarknet53-256": (
        "dcc9b4d1a884ca47cc2a077aeeca2602d40c15c052b192a8928f259b4f53ed7b",
        "272d5e99423fdee088f9975e2d307e637b50760e6f88f90108cea4313d1a57c8"),
}


def _digest(state):
    h = hashlib.sha256()
    for name, t in state.items():
        h.update(name.encode())
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", sorted(FLOPS))
def test_forward_conv_flops_are_unchanged(name):
    size, flops = FLOPS[name]
    assert counts.forward_conv_flops(_config(name), 1, size) == flops


@pytest.mark.parametrize("name", sorted(WEIGHTS))
def test_weights_and_calibration_are_unchanged(one_thread, name):
    cf = _config(name)
    state = weights.make_weights(cf, pc.SEED, "cpu", 0.25, 0.25)
    assert _digest(state) == WEIGHTS[name][0]
    pool = weights.detect_pool(pc.SEED, 1, 2, 64, "cpu")
    weights.calibrate(cf, state, pool[0], 0.25, 0.25)
    assert _digest(state) == WEIGHTS[name][1]


def _edit(root, *parts, **values):
    path = os.path.join(root, *parts)
    with open(path) as f:
        data = json.load(f)
    data.update(values)
    with open(path, "w") as f:
        json.dump(data, f)


@pytest.fixture(scope="module")
def alias_root(tmp_path_factory):
    """The CPU checkout of pb_small with yolov4-608 naming the alias, and
    detect-b64 one batch in flight, so that the CPU's slow batches reach
    the host inside the window and the FLOP count is read."""
    root = pc.make_root(tmp_path_factory)
    _edit(root, "portbench", "configs", "yolov4-608.json", reference=ALIAS)
    _edit(root, "portbench", "traffic", "detect-b64.json", in_flight=1)
    return root


# (contract function, file, harness function) that a traced run of each
# kind must go through
WANT = {
    "detect": {("build", "weights.py", "named_shapes"),
               ("build", "weights.py", "calibrate"),
               ("calibrate_bn", "weights.py", "calibrate"),
               ("build", "detect.py", "check"),
               ("build", "counts.py", "forward_conv_flops")},
    "train": {("build", "weights.py", "named_shapes"),
              ("build", "train.py", "__init__"),
              ("precision", "train.py", "__init__"),
              ("model_input", "train.py", "step"),
              ("loss", "train.py", "step"),
              ("build", "counts.py", "forward_conv_flops")},
}


@pytest.mark.parametrize("cell,kind", [("yolov4-608.detect-b64", "detect"),
                                       ("yolov4-608.train-b24", "train")])
def test_a_whole_run_goes_through_the_named_module(alias_root, cell, kind):
    pb_ref_alias.CALLS.clear()
    result, _ = run_mod.run(alias_root, cell, pc.SEED, 3.0, True,
                            device="cpu", limits=pc.limits(cell))
    assert result["correct"], result["checks"]
    assert WANT[kind] <= set(pb_ref_alias.CALLS), pb_ref_alias.CALLS
    # the reference forward and its FLOP count read the same model
    assert any(m.startswith("mfu.") for m in result["metrics"])


@pytest.mark.parametrize("path,says", [
    ("yolov4_tpu_torch/models/yolov4.py", "not a .py file under portbench/"),
    ("portbench/../yolov4_tpu_torch/models/yolov4.py",
     "not a .py file under portbench/"),
    ("/portbench/reference/model.py", "not a .py file under portbench/"),
    ("portbench/reference/absent.py", "no such file"),
])
def test_a_path_outside_the_benchmark_is_refused(path, says):
    cf = dict(_config("yolov4-608"), reference=path)
    with pytest.raises(ValueError, match="reference") as e:
        reference.module(cf)
    assert path in str(e.value) and says in str(e.value)


def test_a_configuration_without_reference_is_refused():
    cf = _config("yolov4-608")
    del cf["reference"]
    with pytest.raises(ValueError, match="'yolov4-608' names no reference"):
        reference.build(cf)


def test_a_module_short_of_the_contract_is_refused(monkeypatch):
    monkeypatch.delattr(pb_ref_alias, "loss")
    cf = dict(_config("yolov4-608"), reference=ALIAS)
    with pytest.raises(ValueError) as e:
        reference.module(cf)
    assert ALIAS in str(e.value) and str(e.value).endswith("lacks loss")
