"""The port's tools/export_torch.py and tools/run_coco_gate.py on the CPU,
against the JAX package's tools: the exported ``.pth.tar`` of a JAX
``.ckpt`` equal key for key and in its meta fields, the export of a port
checkpoint, the gate's BLOCKED report and remediation hint, and the gate
on tests/test_coco_gate.py's fixture printing the JAX gate's AP and
AP50."""

import importlib.util
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from tests.fixtures import make_fake_coco
from yolov4_tpu.utils.checkpoint import save_checkpoint as jax_save
from yolov4_tpu.utils.torch_convert import convert_state_dict
from yolov4_tpu_torch.config import Config
from yolov4_tpu_torch.engine.predictor import Predictor
from yolov4_tpu_torch.models import build_model
from yolov4_tpu_torch.tools import export_torch, run_coco_gate
from yolov4_tpu_torch.utils.checkpoint import save_checkpoint
from yolov4_tpu_torch.utils.convert import load_weights

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
META = {"epoch": 7, "step": 120, "ap50": 0.5, "ap50_95": 0.25,
        "best_ap50": 0.625, "best_ap50_95": 0.3125}


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _small_cfg():
    return Config.from_dict({"MODEL": {"WIDTH": 0.25, "DEPTH": 0.25,
                                       "COMPUTE_DTYPE": "float32"},
                             "TEST": {"IMGSIZE": 64}})


def _trained_like(cfg, seed=3):
    """A small model whose BN statistics are not the init's."""
    model = build_model(cfg, device="cpu", train=True,
                        generator=torch.Generator().manual_seed(seed))
    rng = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith(("running_mean", "running_var")):
                buf.copy_(torch.rand(buf.shape, generator=rng) + 0.5)
    return model.state_dict()


def test_export_of_a_jax_ckpt_equals_the_jax_tool(tmp_path, monkeypatch):
    variables = convert_state_dict(_trained_like(_small_cfg()))
    jax_save({"variables": variables, "meta": META}, False,
             output_dir=str(tmp_path), filename="model.ckpt")
    ckpt = str(tmp_path / "model.ckpt")
    monkeypatch.setattr(sys, "argv", ["export_torch.py", ckpt,
                                      str(tmp_path / "jax.pth.tar")])
    _jax_tool("export_torch").main()
    assert export_torch.main([ckpt, str(tmp_path / "port.pth.tar")]) == 0
    want = torch.load(tmp_path / "jax.pth.tar", weights_only=False)
    got = torch.load(tmp_path / "port.pth.tar", weights_only=False)
    assert list(got) == list(want)
    for key in export_torch.META_KEYS:
        assert got[key] == want[key] and type(got[key]) is type(want[key])
    assert list(got["state_dict"]) == list(want["state_dict"])
    for name, value in want["state_dict"].items():
        assert got["state_dict"][name].dtype == value.dtype, name
        assert torch.equal(got["state_dict"][name], value), name


def test_export_of_a_port_checkpoint_loads_back(tmp_path):
    cfg = _small_cfg()
    sd = _trained_like(cfg)
    ckpt = save_checkpoint({"variables": sd, "opt_state": {}, "meta": META},
                           False, output_dir=str(tmp_path),
                           filename="checkpoint.pth")
    out = str(tmp_path / "model.pth.tar")
    assert export_torch.main([ckpt, out]) == 0
    blob = torch.load(out, weights_only=True)
    assert list(blob) == ["epoch", "ap50", "ap50_95", "best_ap50",
                          "best_ap50_95", "state_dict"]
    assert [blob[k] for k in export_torch.META_KEYS] == [
        META[k] for k in export_torch.META_KEYS]
    assert set(blob["state_dict"]) == {
        k for k in sd if not k.endswith("num_batches_tracked")}
    for name, value in blob["state_dict"].items():
        assert value.dtype == torch.float32 and torch.equal(value, sd[name])
    # a strict load fills num_batches_tracked; the detections are the same
    images = np.random.default_rng(0).integers(0, 256, (2, 64, 64, 3),
                                               dtype=np.uint8)
    outs = [Predictor(cfg, state_dict=w, batch_size=2, conf_thre=0.001,
                      device="cpu")(images)
            for w in (sd, load_weights(out))]
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


def test_export_refuses_bare_weights(tmp_path):
    path = tmp_path / "weights.pth"
    torch.save({"conv.weight": torch.zeros(1)}, path)
    with pytest.raises(ValueError, match="not a training checkpoint"):
        export_torch.main([str(path), str(tmp_path / "out.pth.tar")])


def test_gate_blocked_reports_both_missing(tmp_path):
    env = {k: v for k, v in os.environ.items()
           if k not in ("COCO_ROOT", "YOLOV4_CKPT")}
    env.update(HOME=str(tmp_path), PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-m", "yolov4_tpu_torch.tools.run_coco_gate",
         "--device", "cpu"], cwd=tmp_path, env=env, capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 2, out.stdout + out.stderr
    assert "COCO gate BLOCKED; missing:" in out.stdout
    assert "val2017" in out.stdout and "weights" in out.stdout


def test_gate_reports_layout_remediation(tmp_path, capsys):
    ann = tmp_path / "annotations"
    ann.mkdir()
    (ann / "instances_val2017.json").write_text("{}")
    (tmp_path / "val2017").mkdir()
    assert run_coco_gate.find_data(str(tmp_path)) is None
    out = capsys.readouterr().out
    assert "images/val2017" in out and "ln -s" in out


@pytest.fixture(scope="module")
def gate_fixture(tmp_path_factory):
    """tests/test_coco_gate.py's fixture: a synthetic val2017, a JAX .ckpt
    and the reduced cfg."""
    import jax

    from yolov4_tpu.config import load_config
    from yolov4_tpu.models.yolov4 import build_model as jax_build_model
    from yolov4_tpu.models.yolov4 import init_variables
    root = tmp_path_factory.mktemp("gate")
    data = str(root / "COCO")
    make_fake_coco(data, "val2017", n_images=4, seed=7)
    cfg = load_config()
    cfg["MODEL"].update(WIDTH=0.25, DEPTH=0.34, COMPUTE_DTYPE="float32",
                        S2D_STEM=False, WPACK=False, SPLIT_HEAD=False,
                        PALLAS_CSP=False, BACKBONE_PRETRAINED=None)
    cfg["TEST"]["IMGSIZE"] = 96
    cfg_path = str(root / "gate.cfg")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    variables = init_variables(jax_build_model(cfg), jax.random.PRNGKey(0),
                               96)
    ckpt = jax_save({"variables": variables}, is_best=False,
                    output_dir=str(root), filename="gate_weights.ckpt")
    return {"data": data, "cfg": cfg_path, "ckpt": ckpt}


def _gate_line(out):
    m = re.search(r"GATE: AP (\d\.\d+) \(published 0\.35925\) "
                  r"AP50 (\d\.\d+) \(published 0\.59468\)", out)
    assert m, out
    return m.group(1), m.group(2)


def test_gate_on_fixture_prints_the_jax_gates_ap(gate_fixture, capsys,
                                                 monkeypatch):
    argv = ["--data", gate_fixture["data"], "--checkpoint",
            gate_fixture["ckpt"], "--cfg", gate_fixture["cfg"],
            "--batch-size", "2", "--pre-nms-topk", "256", "--max-dets", "64"]
    monkeypatch.chdir(REPO)
    monkeypatch.setattr(sys, "argv", ["run_coco_gate.py"] + argv)
    with pytest.raises(SystemExit) as err:
        _jax_tool("run_coco_gate").main()
    assert err.value.code == 1
    want = _gate_line(capsys.readouterr().out)
    assert run_coco_gate.main(argv + ["--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert f"data: {gate_fixture['data']}" in out and "GATE NOT met" in out
    assert _gate_line(out) == want
