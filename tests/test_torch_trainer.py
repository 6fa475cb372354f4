"""The port's Trainer (engine/trainer.py) and train CLI (train.py) on a fake
COCO, on the CPU, at WIDTH = DEPTH = 0.25 and 64x64."""

import json
import os

import numpy as np
import pytest
import torch

from tests.fixtures import make_fake_coco
from yolov4_tpu_torch import train as train_cli
from yolov4_tpu_torch.config import Config
from yolov4_tpu_torch.engine.trainer import Trainer
from yolov4_tpu_torch.utils import checkpoint as ckpt_lib
from yolov4_tpu_torch.utils.convert import load_weights

torch.set_num_threads(1)

SMALL = {
    "MODEL": {"WIDTH": 0.25, "DEPTH": 0.25, "COMPUTE_DTYPE": "float32"},
    "TRAIN": {"IMGSIZE": 64, "MAX_EPOCHS": 2},
    "TEST": {"IMGSIZE": 64, "BATCH_SIZE": 2, "PRE_NMS_TOPK": 64,
             "MAX_DETS": 10},
    "DATA": {"WORKERS": 0, "BATCH_SIZE": 4},
}


@pytest.fixture(scope="module")
def coco_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("coco"))
    make_fake_coco(root, "train2017", n_images=8, seed=0)   # 2 steps/epoch
    make_fake_coco(root, "val2017", n_images=3, seed=1)
    return root


def _cfg(out_dir, **sections):
    raw = {k: dict(v) for k, v in SMALL.items()}
    raw["TRAIN"]["OUTPUT_DIR"] = str(out_dir)
    for key, values in sections.items():
        raw.setdefault(key, {}).update(values)
    return Config.from_dict(raw)


def _records(out_dir, kind):
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        return [r for r in map(json.loads, f) if r["kind"] == kind]


def test_fit_two_epochs_writes_metrics_and_checkpoints(tmp_path, coco_root):
    out = tmp_path / "run"
    trainer = Trainer(_cfg(out), coco_root, device="cpu", print_freq=1)
    # AP of random weights is 0; score the epochs so that best tracking
    # has something to track
    scores = iter([(0.1, 0.3), (0.2, 0.25)])
    real_evaluate = trainer.evaluate
    trainer.evaluate = lambda: (real_evaluate(), next(scores))[1]
    best = trainer.fit()
    assert best == (0.2, 0.3)
    assert trainer.state.step == 4
    train = _records(out, "train")
    assert [r["step"] for r in train] == [1, 2, 3, 4]
    assert all(np.isfinite(r["loss"]) and r["lr"] > 0 for r in train)
    assert [r["epoch"] for r in _records(out, "eval")] == [1, 2]
    assert [r["images"] for r in _records(out, "train_epoch")] == [8, 8]
    meta = json.load(open(out / "checkpoint.pth.meta.json"))
    assert meta["epoch"] == 1 and meta["step"] == 4
    assert meta["best_ap50"] == 0.3 and meta["ap50"] == 0.25
    best_meta = json.load(open(out / "model_best.pth.meta.json"))
    assert best_meta["epoch"] == 0 and best_meta["ap50"] == 0.3
    # val/detect read the checkpoint's weights: the last epoch's
    sd = load_weights(str(out / "checkpoint.pth"))
    for key, val in trainer.model.state_dict().items():
        assert torch.equal(sd[key], val), key


def test_evaluate_only_scores_resumed_weights(tmp_path, coco_root):
    trainer = Trainer(_cfg(tmp_path / "a", TRAIN={"MAX_EPOCHS": 1}),
                      coco_root, device="cpu")
    trainer.fit()
    ckpt = str(tmp_path / "a" / "checkpoint.pth")
    ev = Trainer(_cfg(tmp_path / "e"), coco_root, resume=ckpt,
                 evaluate_only=True, device="cpu")
    assert ev.train_loader is None and ev.train_step is None
    ap, ap50 = ev.fit(evaluate_only=True)
    assert 0.0 <= ap <= ap50 <= 1.0
    for key, val in ev.predictor.model.state_dict().items():
        assert torch.equal(val, trainer.model.state_dict()[key]), key


def test_ema_run_scores_and_saves_the_shadow_weights(tmp_path, coco_root):
    out = tmp_path / "ema"
    trainer = Trainer(_cfg(out, TRAIN={"MAX_EPOCHS": 1, "EMA_DECAY": 0.5}),
                      coco_root, device="cpu")
    trainer.fit()
    raw = ckpt_lib.load_checkpoint_raw(str(out / "checkpoint.pth"))
    assert raw["meta"]["ema_decay"] == 0.5
    name = "backbone.stem.conv.weight"
    params = dict(trainer.model.named_parameters())
    assert torch.equal(raw["raw_params"][name], params[name].detach())
    assert torch.equal(raw["variables"][name], trainer.state.ema_params[name])
    assert not torch.equal(raw["variables"][name], raw["raw_params"][name])
    # the Predictor scored the EMA weights
    assert torch.equal(trainer.predictor.model.state_dict()[name],
                       trainer.state.ema_params[name])


def test_multiscale_run_follows_the_size_schedule(tmp_path, coco_root):
    out = tmp_path / "ms"
    cfg = _cfg(out, TRAIN={"MAX_EPOCHS": 1, "MULTISCALE": [64, 96],
                           "MULTISCALE_EVERY": 1})
    trainer = Trainer(cfg, coco_root, device="cpu", seed=3)
    sizes, real_step = [], trainer.train_step

    def recording(state, images, labels):
        sizes.append(images.shape[1])
        return real_step(state, images, labels)

    trainer.train_step = recording
    trainer.fit()
    assert sizes == [trainer._ms_size_for(0, i) for i in range(2)]
    assert set(sizes) <= {64, 96}


def _write_cfg(path, out_dir):
    import yaml
    raw = {k: dict(v) for k, v in SMALL.items()}
    raw["TRAIN"].update(MAX_EPOCHS=1, OUTPUT_DIR=str(out_dir))
    with open(path, "w") as f:
        yaml.safe_dump(raw, f)
    return str(path)


def test_cli_trains_on_the_cpu(tmp_path, coco_root):
    cfg = _write_cfg(tmp_path / "small.cfg", tmp_path / "cli")
    best = train_cli.main([coco_root, "-c", cfg, "--device", "cpu",
                           "--print-freq", "1", "--opt-level", "O0",
                           "--sync_bn", "--deterministic"])
    assert len(best) == 2
    assert (tmp_path / "cli" / "checkpoint.pth").exists()
    assert len(_records(tmp_path / "cli", "train")) == 2


def test_cli_without_device_needs_cuda(tmp_path, coco_root, monkeypatch):
    """No --device means CUDA; without a card the CLI stops with a
    message and never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _write_cfg(tmp_path / "small.cfg", tmp_path / "none")
    with pytest.raises(SystemExit) as err:
        train_cli.main([coco_root, "-c", cfg])
    assert "CUDA" in str(err.value)
    assert err.value.code not in (0, None)
    assert not (tmp_path / "none").exists()
