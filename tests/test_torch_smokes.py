"""The port's learning smokes on the CPU (tools/overfit_smoke.py,
tools/generalization_smoke.py) and their data (data/synthetic.py), against
the JAX package's tools and tests/fixtures.py: the same datasets on disk,
the same config from each CLI, the same first training batch; then each
``run`` over a few steps at WIDTH/DEPTH 0.25 and 64x64 in float32 (the
loss falls, the result's schema), the Trainer path with --quant-eval, and
the --resume refusals."""

import importlib.util
import json
import os
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from tests import fixtures
from yolov4_tpu_torch.data import synthetic
from yolov4_tpu_torch.tools import generalization_smoke as gen
from yolov4_tpu_torch.tools import overfit_smoke as ov

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
SMALL = ["--img-size", "64", "--batch-size", "2"]
GEN_SMALL = SMALL + ["--train-images", "4", "--val-images", "2",
                     "--epochs", "1"]
RUN = {ov: ov.run, gen: gen.run}   # before any test replaces them


def _split(root, name):
    with open(os.path.join(root, "annotations",
                           f"instances_{name}.json")) as f:
        blob = json.load(f)
    pixels = {img["file_name"]: cv2.imread(os.path.join(
        root, "images", name, img["file_name"])) for img in blob["images"]}
    return blob, pixels


@pytest.mark.parametrize("maker,kwargs", [
    ("make_fake_coco", {"n_images": 4, "seed": 11, "img_hw": (240, 320)}),
    ("make_shapes_coco", {"n_images": 4, "seed": 100, "img_hw": (96, 96),
                          "id_base": 1000}),
    ("make_shapes_coco", {"n_images": 4, "seed": 999, "img_hw": (96, 96),
                          "id_base": 90000, "hard": True}),
])
def test_synthetic_equals_fixtures(tmp_path, maker, kwargs):
    ids = getattr(synthetic, maker)(str(tmp_path / "port"), "val2017",
                                    **kwargs)
    want_ids = getattr(fixtures, maker)(str(tmp_path / "jax"), "val2017",
                                        **kwargs)
    assert ids == want_ids
    got, got_px = _split(str(tmp_path / "port"), "val2017")
    want, want_px = _split(str(tmp_path / "jax"), "val2017")
    assert got == want
    assert got_px.keys() == want_px.keys()
    for name in got_px:
        np.testing.assert_array_equal(got_px[name], want_px[name])


# --- the JAX tools, driven up to their first train step -------------------

class _Stop(Exception):
    pass


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _capture_jax(name, argv, monkeypatch):
    """The cfg a JAX tool builds and the first batch it feeds its step
    (the model, optimizer and step replaced by stubs)."""
    mod = _jax_tool(name)
    got = {}

    def build_model(cfg):
        got["cfg"] = json.loads(json.dumps(cfg))
        return None

    def make_train_step(*args, **kwargs):
        def step(state, flat, labels):
            got["flat"], got["labels"] = np.asarray(flat), np.asarray(labels)
            raise _Stop
        return step

    class Trainer:
        def __init__(self, cfg, *args, **kwargs):
            got["cfg"] = json.loads(json.dumps(cfg))
            raise _Stop

    for attr, value in (
            ("build_model", build_model),
            ("init_variables", lambda *a: {"params": {}, "batch_stats": {}}),
            ("build_optimizer", lambda *a: None),
            ("build_lr_schedule", lambda *a, **k: None),
            ("build_criterion", lambda *a: None),
            ("create_mesh", lambda: None),
            ("create_train_state", lambda *a: None),
            ("make_train_step", make_train_step)):
        monkeypatch.setattr(mod, attr, value)
    import yolov4_tpu.engine.trainer
    monkeypatch.setattr(yolov4_tpu.engine.trainer, "Trainer", Trainer)
    monkeypatch.setattr(sys, "argv", [f"{name}.py"] + argv)
    with pytest.raises(_Stop):
        mod.main()
    return got


def _capture_port_cfg(tool, argv, monkeypatch):
    got = {}

    def run(cfg, args):
        got["cfg"] = json.loads(json.dumps(cfg))
        return {"ap50": 1.0}

    monkeypatch.setattr(tool, "run", run)
    tool.main(argv + ["--device", "cpu"])
    return got["cfg"]


def _capture_port_batch(tool, argv, monkeypatch):
    """The first batch the port's tool feeds its train step."""
    got = {}

    def build_train(cfg, device, len_epoch, seed=0):
        def step(state, images, labels):
            got["images"] = images.float().numpy()
            got["labels"] = labels.numpy()
            raise _Stop
        return None, step, None

    monkeypatch.setattr(tool, "build_train", build_train)
    args = (ov.parse_args(argv) if tool is ov
            else gen.build_parser().parse_args(argv))
    with pytest.raises(_Stop):
        RUN[tool](tool.build_cfg(args), args)
    return got


def _same_batch(jax_got, port_got):
    b = port_got["images"].shape[0]
    np.testing.assert_array_equal(
        jax_got["flat"].astype(np.float32).reshape(port_got["images"].shape),
        port_got["images"])
    assert jax_got["flat"].shape[0] == b
    np.testing.assert_array_equal(jax_got["labels"], port_got["labels"])


def test_overfit_cfg_and_first_batch_equal_jax(tmp_path, monkeypatch):
    argv = SMALL + ["--steps", "2"]
    want = _capture_jax("overfit_smoke", argv + ["--root",
                                                 str(tmp_path / "jax")],
                        monkeypatch)
    got_cfg = _capture_port_cfg(ov, argv + ["--root", str(tmp_path / "jax")],
                                monkeypatch)
    assert got_cfg == want["cfg"]
    got = _capture_port_batch(ov, argv + ["--root", str(tmp_path / "port"),
                                          "--device", "cpu"], monkeypatch)
    _same_batch(want, got)


def test_generalization_cfg_and_first_batch_equal_jax(tmp_path,
                                                      monkeypatch):
    want = _capture_jax("generalization_smoke",
                        GEN_SMALL + ["--root", str(tmp_path / "jax")],
                        monkeypatch)
    got_cfg = _capture_port_cfg(gen, GEN_SMALL + ["--root",
                                                  str(tmp_path / "jax")],
                                monkeypatch)
    assert got_cfg == want["cfg"]
    got = _capture_port_batch(gen, GEN_SMALL + ["--root",
                                                str(tmp_path / "port"),
                                                "--device", "cpu"],
                              monkeypatch)
    _same_batch(want, got)


@pytest.mark.parametrize("extra", [
    ["--use-trainer"],
    ["--use-trainer", "--recipe", "--device-aug", "--ema", "0.99",
     "--multiscale", "32,64", "--box-loss", "ciou", "--letterbox",
     "--seed", "3", "--hard", "--width", "0.25", "--depth", "0.5",
     "--epochs", "6"],
])
def test_generalization_trainer_cfg_equals_jax(tmp_path, monkeypatch, extra):
    argv = GEN_SMALL + ["--root", str(tmp_path)] + extra
    want = _capture_jax("generalization_smoke", argv, monkeypatch)
    assert _capture_port_cfg(gen, argv, monkeypatch) == want["cfg"]


def test_overfit_first_loss_equals_jax_tool(tmp_path, monkeypatch):
    """The step-1 loss of both overfit tools at their batch of 8 on their
    own fixed batch, at 64x64, WIDTH/DEPTH 0.25 and float32: the port at
    its seed-0 init, the JAX tool at PRNGKey(0) on a one-device mesh. At
    both inits the objectness logits sit near 0, so the loss is about 252
    anchors x 8 images x ln 2 plus the box and class terms. On an
    8-device mesh the JAX step reports the mean of the shards' sums, an
    eighth (run with -s to print)."""
    import jax

    from yolov4_tpu.parallel import create_mesh
    got = {}
    jax_tool = _jax_tool("overfit_smoke")
    build_model, make_train_step = (jax_tool.build_model,
                                    jax_tool.make_train_step)

    def small_model(cfg):
        cfg["MODEL"].update(WIDTH=0.25, DEPTH=0.25, COMPUTE_DTYPE="float32")
        return build_model(cfg)

    monkeypatch.setattr(jax_tool, "build_model", small_model)
    monkeypatch.setattr(sys, "argv", ["overfit_smoke.py", "--img-size",
                                      "64", "--root", str(tmp_path / "jax")])
    for n in (1, 8):
        def first_jax_step(*args, **kwargs):
            step = make_train_step(*args, **kwargs)

            def first(state, flat, labels):
                got[n] = float(step(state, flat, labels).loss)
                raise _Stop
            return first

        monkeypatch.setattr(jax_tool, "make_train_step", first_jax_step)
        monkeypatch.setattr(jax_tool, "create_mesh",
                            lambda: create_mesh(jax.devices()[:n]))
        with pytest.raises(_Stop):
            jax_tool.main()

    build_train = ov.build_train

    def first_port_step(*args, **kwargs):
        model, step, state = build_train(*args, **kwargs)

        def first(state, images, labels):
            got["port"] = float(step(state, images, labels).loss)
            raise _Stop
        return model, first, state

    monkeypatch.setattr(ov, "build_train", first_port_step)
    args = ov.parse_args(["--img-size", "64", "--root",
                          str(tmp_path / "port"), "--device", "cpu"])
    with pytest.raises(_Stop):
        RUN[ov](_small(ov.build_cfg(args)), args)
    floor = 3 * (8 ** 2 + 4 ** 2 + 2 ** 2) * 8 * np.log(2)
    print(f"step-1 loss: port {got['port']:.1f}; JAX tool on 1 device "
          f"{got[1]:.1f}, on 8 devices {got[8]:.1f}; objectness alone at "
          f"0.5: {floor:.1f}")
    assert got[1] > floor and got["port"] > floor
    np.testing.assert_allclose(got["port"], got[1], rtol=0.01)
    np.testing.assert_allclose(got[8], got[1] / 8, rtol=0.01)


# --- the port's tools at a small size --------------------------------------

def _small(cfg):
    cfg["MODEL"].update(WIDTH=0.25, DEPTH=0.25, COMPUTE_DTYPE="float32")
    return cfg


def test_overfit_run_learns_and_reports(tmp_path):
    args = ov.parse_args(SMALL + ["--steps", "12", "--root",
                                  str(tmp_path / "coco"), "--device", "cpu"])
    r = ov.run(_small(ov.build_cfg(args)), args)
    assert set(r) == {"losses", "final_loss", "ap", "ap50", "steps",
                      "step_ms", "train_seconds", "seconds", "launches",
                      "quant"}
    assert r["losses"][0][0] == 1 and r["steps"] == 12
    assert np.isfinite(r["final_loss"])
    assert r["final_loss"] < r["losses"][0][1]
    assert 0.0 <= r["ap"] <= r["ap50"] <= 1.0
    # the plain versions run on the CPU: no kernel launches
    assert r["launches"] == {"greedy_nms_mask": 0, "fused_csp_stage": 0,
                             "batch_norm_act": 0}
    assert r["quant"] == {}


def test_generalization_run_learns_and_reports(tmp_path):
    args = gen.build_parser().parse_args(
        SMALL + ["--train-images", "8", "--val-images", "2", "--epochs",
                 "5", "--root", str(tmp_path), "--device", "cpu"])
    r = gen.run(_small(gen.build_cfg(args)), args)
    assert set(r) == {"mode", "losses", "ap", "ap50", "train_ap",
                      "train_ap50", "steps", "step_ms", "train_seconds",
                      "seconds", "weights", "launches"}
    assert r["mode"] == "manual" and r["steps"] == 20
    assert [e for e, _, _ in r["losses"]] == [1, 5]
    assert r["losses"][-1][2] < r["losses"][0][2]
    assert 0.0 <= r["ap"] <= r["ap50"] <= 1.0
    assert 0.0 <= r["train_ap"] <= r["train_ap50"] <= 1.0
    assert len(r["weights"]) > 100 and all(
        isinstance(v, torch.Tensor) for v in r["weights"].values())


def test_generalization_trainer_with_quant_eval(tmp_path, capsys):
    args = gen.build_parser().parse_args(
        SMALL + ["--train-images", "8", "--val-images", "2", "--epochs",
                 "2", "--root", str(tmp_path), "--device", "cpu",
                 "--use-trainer", "--quant-eval"])
    r = gen.run(_small(gen.build_cfg(args)), args)
    assert r["mode"] == "trainer"
    assert r["output_dir"] == str(tmp_path / "out")
    records = [json.loads(line) for line in
               (tmp_path / "out" / "metrics.jsonl").read_text().splitlines()]
    assert [e["epoch"] for e in records if e["kind"] == "eval"] == [1, 2]
    assert set(r["quant"]) == {"bf16", "int8/late", "int8/full",
                               "int8_static/late", "int8_static/full",
                               "approx_topk"}
    # approx-topk is ignored by the port: exactly the bf16 baseline
    assert r["quant"]["approx_topk"]["ap"] == r["quant"]["bf16"]["ap"]
    assert r["quant"]["approx_topk"]["delta_ap50"] == 0.0
    # the raw training weights are scored, as the JAX tool's state.params
    assert all(torch.equal(v, r["weights"][k]) for k, v in
               torch.load(tmp_path / "out" / "checkpoint.pth",
                          weights_only=True)["variables"].items()
               if not k.endswith("num_batches_tracked"))
    out = capsys.readouterr().out
    assert "TRAINER mode (host aug)" in out and "approx_topk" in out


def test_resume_without_trainer_is_refused(tmp_path):
    gen.prepare_dataset(gen.build_parser().parse_args(
        GEN_SMALL + ["--root", str(tmp_path)]))
    before = sorted(p.name for p in tmp_path.rglob("*"))
    with pytest.raises(SystemExit) as err:
        gen.main(GEN_SMALL + ["--root", str(tmp_path), "--resume",
                              str(tmp_path / "out" / "checkpoint.pth"),
                              "--device", "cpu"])
    assert err.value.code == 2
    assert sorted(p.name for p in tmp_path.rglob("*")) == before


def test_resume_with_other_dataset_flags_keeps_the_root(tmp_path, capsys):
    """The JAX tool deletes the root (and the checkpoint it resumes) when
    the dataset flags differ from its stamp; the port refuses first."""
    gen.prepare_dataset(gen.build_parser().parse_args(
        GEN_SMALL + ["--root", str(tmp_path)]))
    ckpt = tmp_path / "out" / "checkpoint.pth"
    ckpt.parent.mkdir()
    ckpt.write_bytes(b"a checkpoint")
    stamp = (tmp_path / "dataset_params.json").read_text()
    with pytest.raises(SystemExit) as err:
        gen.main(SMALL + ["--train-images", "6", "--val-images", "2",
                          "--root", str(tmp_path), "--use-trainer",
                          "--resume", str(ckpt), "--device", "cpu"])
    assert err.value.code == 2
    assert "--resume" in capsys.readouterr().err
    assert ckpt.read_bytes() == b"a checkpoint"
    assert (tmp_path / "dataset_params.json").read_text() == stamp
    assert len(list((tmp_path / "images" / "train2017").iterdir())) == 4


def test_changed_dataset_flags_regenerate_the_root(tmp_path):
    parse = gen.build_parser().parse_args
    gen.prepare_dataset(parse(GEN_SMALL + ["--root", str(tmp_path)]))
    (tmp_path / "stale.txt").write_text("left from another run")
    gen.prepare_dataset(parse(SMALL + ["--train-images", "6", "--val-images",
                                       "3", "--root", str(tmp_path)]))
    assert not (tmp_path / "stale.txt").exists()
    assert json.loads((tmp_path / "dataset_params.json").read_text()) == {
        "train_images": 6, "val_images": 3, "img_size": 64, "hard": False}
    assert len(list((tmp_path / "images" / "train2017").iterdir())) == 6
    assert len(list((tmp_path / "images" / "val2017").iterdir())) == 3
