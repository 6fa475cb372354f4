"""The port's classifier pretrainer (yolov4_tpu_torch/classify/,
models/darknet.py::CSPDarknet53, darknet_pretrain.py) against the JAX
package's on the CPU: the same numpy-drawn images, folders and weights
through both, WIDTH = DEPTH = 0.25, 64x64 (32x32 in the Trainer runs),
float32, one thread. Tolerances are stated at each comparison."""

import json
import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from tests.fixtures import make_fake_coco
from tests.test_torch_helpers import small_cfgs, spread_variables
from yolov4_tpu.classify import data as jax_data
from yolov4_tpu.classify import trainer as jax_trainer
from yolov4_tpu.data.pipeline import DataLoader as JaxDataLoader
from yolov4_tpu.models.darknet import CSPDarknet53 as JaxCSPDarknet53
from yolov4_tpu.parallel import create_mesh
from yolov4_tpu.parallel.train_step import \
    create_train_state as jax_create_train_state
from yolov4_tpu.utils import checkpoint as jax_ckpt
from yolov4_tpu_torch import darknet_pretrain
from yolov4_tpu_torch.classify import data
from yolov4_tpu_torch.classify.trainer import (ClassifierTrainer,
                                               classifier_lr_schedule,
                                               make_cls_train_step,
                                               make_eval_step,
                                               normalize_images, smoothed_ce)
from yolov4_tpu_torch.data.pipeline import DataLoader
from yolov4_tpu_torch.engine.trainer import Trainer
from yolov4_tpu_torch.models.darknet import CSPDarknet53
from yolov4_tpu_torch.parallel.train_step import TrainState
from yolov4_tpu_torch.utils.convert import state_dict_from_jax
from yolov4_tpu_torch.utils.logging import setup_logging

torch.set_num_threads(1)

CLASSES = 7
SIZE = 64
# the Trainer runs: 2 classes, 4 train and 3 val images each, batch 2
TRAINER_KW = dict(batch_size=2, epochs=2, workers=0, crop_size=32,
                  val_size=36, num_classes=2, seed=0, width=0.25,
                  depth=0.25, print_freq=1, compute_dtype=torch.float32,
                  device="cpu")


def _write_folders(root, per_split, shapes, seed):
    rng = np.random.default_rng(seed)
    for split, n in per_split:
        for cls in ("alpha", "beta"):
            d = os.path.join(root, split, cls)
            os.makedirs(d)
            for i in range(n):
                h, w = shapes[i % len(shapes)]
                Image.fromarray(rng.integers(0, 255, (h, w, 3), np.uint8)
                                ).save(os.path.join(d, f"{i}.jpg"))
    return root


@pytest.fixture(scope="module")
def image_root(tmp_path_factory):
    """Portrait, landscape and small images, so that the crop's fallback
    and both resize branches run."""
    return _write_folders(str(tmp_path_factory.mktemp("imagenet")),
                          [("train", 6), ("val", 3)],
                          [(70, 90), (96, 60), (40, 44)], seed=0)


@pytest.fixture(scope="module")
def trainer_root(tmp_path_factory):
    return _write_folders(str(tmp_path_factory.mktemp("imagenet_fit")),
                          [("train", 4), ("val", 3)], [(48, 56)], seed=1)


def _u8(seed, b=4, size=SIZE):
    return np.random.default_rng(seed).integers(0, 256, (b, size, size, 3),
                                                np.uint8)


@pytest.fixture(scope="module")
def jax_pair():
    """The JAX classifier (plain lowerings, float32), its jitted eval
    forward and eval step, and its variables with BN re-drawn
    (tests/test_torch_helpers.spread_variables) and a zero classifier
    bias; and the port's model carrying the same weights."""
    jmodel = JaxCSPDarknet53(num_classes=CLASSES, dtype=jnp.float32,
                             width=0.25, depth=0.25, s2d=False, wpack=False)
    init = jax.jit(lambda r, d: jmodel.init({"params": r}, d, train=False))
    jvars = spread_variables(jax.device_get(init(
        jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)))), seed=3)
    jvars["params"]["classifier"]["bias"] = np.zeros(CLASSES, np.float32)
    model = CSPDarknet53(CLASSES, width=0.25, depth=0.25)
    model.load_state_dict(state_dict_from_jax(jvars))
    return dict(model=jmodel, vars=jvars, port=model,
                forward=jax.jit(lambda v, x: jmodel.apply(v, x, train=False)),
                eval_step=jax_trainer.make_eval_step(jmodel, SIZE))


# ---------------------------------------------------------------------------
# data and schedule: bit-equal to the JAX package's


def _pil(seed, hw=(64, 80)):
    return Image.fromarray(np.random.default_rng(seed).integers(
        0, 256, hw + (3,), np.uint8))


OPS = [name for name, _ in jax_data.RandAugment()._space(64)]


@pytest.mark.parametrize("op", OPS)
def test_randaugment_op_bit_equal(op):
    img = _pil(1)
    ours = dict(data.RandAugment()._space(min(img.size)))
    theirs = dict(jax_data.RandAugment()._space(min(img.size)))
    assert ours[op] == theirs[op]
    for seed in range(4):   # both signs of the magnitude
        got = data.RandAugment._apply(img, op, ours[op], random.Random(seed))
        want = jax_data.RandAugment._apply(img, op, theirs[op],
                                           random.Random(seed))
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_randaugment_and_crops_bit_equal():
    for seed in range(6):
        img = _pil(seed, [(64, 80), (90, 50), (30, 30)][seed % 3])
        for fn in (lambda m, r: m.RandAugment()(img, r),
                   lambda m, r: m.random_resized_crop(img, 32, r),
                   lambda m, r: m.random_resized_crop(img, 32, r,
                                                      scale=(2.0, 3.0))):
            np.testing.assert_array_equal(
                np.asarray(fn(data, random.Random(seed))),
                np.asarray(fn(jax_data, random.Random(seed))))
        np.testing.assert_array_equal(
            np.asarray(data.resize_center_crop(img, 36, 32)),
            np.asarray(jax_data.resize_center_crop(img, 36, 32)))
    np.testing.assert_array_equal(data.IMAGENET_MEAN, jax_data.IMAGENET_MEAN)
    np.testing.assert_array_equal(data.IMAGENET_STD, jax_data.IMAGENET_STD)


@pytest.mark.parametrize("train", [True, False])
def test_image_folder_loader_bit_equal(image_root, train):
    """The port's ImageFolderDataset through the port's DataLoader against
    the JAX package's through its own: train (shuffled, seeded, drop_last)
    over two epochs, and val with its padded last batch."""
    split = "train" if train else "val"
    kw = dict(crop_size=32, val_size=36, is_train=train, seed=4)
    ours = data.ImageFolderDataset(f"{image_root}/{split}", **kw)
    theirs = jax_data.ImageFolderDataset(f"{image_root}/{split}", **kw)
    assert ours.samples == theirs.samples
    assert ours.class_to_idx == {"alpha": 0, "beta": 1}
    lkw = dict(batch_size=4, shuffle=train, seed=9, drop_last=train)
    loaders = (DataLoader(ours, **lkw), JaxDataLoader(theirs, **lkw))
    n_batches = 0
    for epoch in (0, 1) if train else (0,):
        for loader in loaders:
            loader.set_epoch(epoch)
        for (img, tgt), (jimg, jtgt) in zip(*loaders):
            assert img.dtype == np.uint8 and img.shape == (4, 32, 32, 3)
            np.testing.assert_array_equal(img, jimg)
            assert set(tgt) == set(jtgt) == {"label", "batch_mask"}
            for key in tgt:
                np.testing.assert_array_equal(tgt[key], jtgt[key])
            assert tgt["label"].dtype == np.int32
            n_batches += 1
    assert n_batches == (6 if train else 2)


def test_lr_schedule_matches_jax():
    """Within 1e-7 over steps that cross the warmup and every milestone."""
    base, len_epoch = 0.05, 20
    ours = classifier_lr_schedule(base, len_epoch)
    theirs = jax_trainer.classifier_lr_schedule(base, len_epoch)
    for epoch in (0, 3, 4, 5, 59, 60, 89, 90, 109, 110, 119):
        for i in (0, 7, 19):
            step = epoch * len_epoch + i
            assert abs(ours(step) - float(theirs(step))) <= 1e-7, step


def test_smoothed_ce_matches_jax():
    """Within 1e-6 of optax's smooth_labels + softmax_cross_entropy."""
    rng = np.random.default_rng(0)
    logits = rng.normal(0, 3, (6, CLASSES)).astype(np.float32)
    labels = np.array([0, 4, 2, 2, 1, 3], np.int32)
    want = float(jax_trainer.smoothed_ce(jnp.asarray(logits),
                                         jnp.asarray(labels), CLASSES))
    got = float(smoothed_ce(torch.from_numpy(logits),
                            torch.from_numpy(labels)))
    assert abs(got - want) <= 1e-6


def test_normalize_images_bit_equal():
    u8 = _u8(0)
    want = np.asarray(jax_trainer.normalize_images(jnp.asarray(u8)))
    got = normalize_images(torch.from_numpy(u8))
    assert got.shape == (4, 3, SIZE, SIZE) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


# ---------------------------------------------------------------------------
# the model


def test_classifier_weights_carry_over(jax_pair):
    """state_dict_from_jax maps the Dense kernel [in, out] to
    classifier.weight [out, in]; the port's own init has the same keys and
    shapes, and flax's lecun-normal scale."""
    jvars = jax_pair["vars"]
    sd = state_dict_from_jax(jvars)
    np.testing.assert_array_equal(
        sd["classifier.weight"].numpy(),
        np.asarray(jvars["params"]["classifier"]["kernel"]).T)
    fresh = CSPDarknet53(CLASSES, width=0.25, depth=0.25,
                         generator=torch.Generator().manual_seed(1))
    assert {k: v.shape for k, v in fresh.state_dict().items()} == \
        {k: v.shape for k, v in sd.items()}
    w = fresh.classifier.weight.detach()
    assert w.abs().max() <= 2.0 / np.sqrt(256) / 0.8796256610342398 + 1e-6
    assert abs(float(w.std()) * np.sqrt(256) - 1.0) < 0.1
    assert torch.equal(fresh.classifier.bias, torch.zeros(CLASSES))


@pytest.mark.parametrize("train", [False, True])
def test_logits_match_jax(jax_pair, train):
    """Logits within 1e-4 of (1 + max |JAX logit|), and in train mode the
    updated BN statistics within rtol 1e-4, atol 1e-6."""
    jvars, model = jax_pair["vars"], jax_pair["port"]
    u8 = _u8(1)
    x = jax_trainer.normalize_images(jnp.asarray(u8))
    if train:
        want, mutated = jax.jit(lambda v, x: jax_pair["model"].apply(
            v, x, train=True, mutable=["batch_stats"]))(jvars, x)
        model = CSPDarknet53(CLASSES, width=0.25, depth=0.25)
        model.load_state_dict(state_dict_from_jax(jvars))
        model.train()
    else:
        want = jax_pair["forward"](jvars, x)
        model.eval()
    with torch.no_grad():
        got = model(normalize_images(torch.from_numpy(u8))).numpy()
    want = np.asarray(want)
    assert got.shape == want.shape == (4, CLASSES)
    assert np.abs(got - want).max() <= 1e-4 * (1 + np.abs(want).max())
    if train:
        stats = state_dict_from_jax({"batch_stats": mutated["batch_stats"]})
        sd = model.state_dict()
        for key, w in stats.items():
            if not key.endswith("num_batches_tracked"):
                np.testing.assert_allclose(sd[key].numpy(), w.numpy(),
                                           rtol=1e-4, atol=1e-6,
                                           err_msg=key)


# ---------------------------------------------------------------------------
# the step and the eval counts against JAX's on a one-device mesh

BASE_LR, LEN_EPOCH = 0.05, 1   # warmup: lr 0.01, then 0.02
# Adam's eps in both steps. At the Trainer's 1e-8 Adam moves every element
# by about lr whatever its gradient's size, so the 5-40 elements of a
# stage-4/5 kernel whose gradients cancel to below float32 noise step in
# opposite directions in two correct implementations (1.9x the tensor's
# largest change); at 1e-3 such elements still reach 2.2e-3 of it. At 1e-2
# an element's step stays in proportion to its gradient where that is
# small: the worst tensor is 4e-4 of its largest change.
ADAM_EPS = 1e-2


@pytest.fixture(scope="module")
def two_steps(jax_pair):
    jmodel, jvars = jax_pair["model"], jax_pair["vars"]
    batches = [(_u8(10 + i), np.array([0, 3, 1, 4], np.int32) + i % 2)
               for i in range(2)]
    tx = optax.scale_by_adam(b1=0.9, b2=0.999, eps=ADAM_EPS)
    jstep = jax_trainer.make_cls_train_step(
        jmodel, tx, jax_trainer.classifier_lr_schedule(BASE_LR, LEN_EPOCH),
        create_mesh(jax.devices()[:1]), CLASSES, size=SIZE)
    state = jax_create_train_state(
        jax.tree.map(jnp.asarray, jvars), tx)
    jax_losses = []
    for u8, labels in batches:
        state = jstep(state, jnp.asarray(u8), jnp.asarray(labels))
        jax_losses.append(float(state.loss))
    want = state_dict_from_jax(jax.device_get(
        {"params": state.params, "batch_stats": state.batch_stats}))

    model = CSPDarknet53(CLASSES, width=0.25, depth=0.25)
    model.load_state_dict(state_dict_from_jax(jvars))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt = torch.optim.Adam(model.parameters(), lr=0.0, betas=(0.9, 0.999),
                           eps=ADAM_EPS)
    step = make_cls_train_step(model, opt,
                               classifier_lr_schedule(BASE_LR, LEN_EPOCH))
    tstate, losses = TrainState(), []
    for u8, labels in batches:
        tstate = step(tstate, torch.from_numpy(u8), torch.from_numpy(labels))
        losses.append(float(tstate.loss))
    return dict(jax_losses=jax_losses, losses=losses, want=want,
                before=before, got=model.state_dict(), step=tstate.step,
                params={n for n, _ in model.named_parameters()})


def test_two_steps_loss_matches_jax(two_steps):
    """rtol 1e-5."""
    assert two_steps["step"] == 2
    np.testing.assert_allclose(two_steps["losses"], two_steps["jax_losses"],
                               rtol=1e-5)


def test_two_steps_parameters_match_jax(two_steps):
    """Each parameter's change over the two Adam updates within 1e-3 of its
    tensor's largest change."""
    got, want, before = two_steps["got"], two_steps["want"], two_steps["before"]
    for key in two_steps["params"]:
        upd = (want[key] - before[key]).numpy()
        err = np.abs((got[key] - before[key]).numpy() - upd).max()
        assert err <= 1e-3 * np.abs(upd).max(), (key, err)


def test_two_steps_bn_stats_match_jax(two_steps):
    """rtol 1e-4, atol 1e-6."""
    for key, w in two_steps["want"].items():
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(two_steps["got"][key].numpy(),
                                       w.numpy(), rtol=1e-4, atol=1e-6,
                                       err_msg=key)


@pytest.mark.parametrize("ties", [False, True])
def test_eval_counts_match_jax(jax_pair, ties):
    """Masked top-1/top-5 counts equal JAX's make_eval_step's, a masked row
    included; with a zero classifier every logit ties, and both rank the
    classes by index."""
    jvars = jax.tree.map(np.copy, jax_pair["vars"])
    if ties:
        jvars["params"]["classifier"]["kernel"][:] = 0.0
    model = CSPDarknet53(CLASSES, width=0.25, depth=0.25)
    model.load_state_dict(state_dict_from_jax(jvars))
    u8 = _u8(2, b=6)
    logits = np.asarray(jax_pair["forward"](
        jvars, jax_trainer.normalize_images(jnp.asarray(u8))))
    order = np.argsort(-logits, axis=-1, kind="stable")
    # two top-1 hits, two top-5 hits past the first, a miss, a masked hit
    labels = np.array([order[0, 0], order[1, 0], order[2, 2], order[3, 4],
                       order[4, 6], order[5, 0]], np.int32)
    mask = np.array([True] * 5 + [False])
    want = jax_pair["eval_step"](jvars, jnp.asarray(u8), jnp.asarray(labels),
                                 jnp.asarray(mask))
    got = make_eval_step(model)(torch.from_numpy(u8),
                                torch.from_numpy(labels),
                                torch.from_numpy(mask))
    assert [int(v) for v in got] == [int(v) for v in want]
    assert [int(v) for v in got] == [2, 4, 5]
    if ties:
        assert order[:, 0].tolist() == [0] * 6


# ---------------------------------------------------------------------------
# the Trainer and its checkpoints

TRAIN_KEYS = {"ts", "kind", "epoch", "step", "loss", "lr", "img_s",
              "batch_time_s"}      # JAX classify/trainer.py:328-333
EVAL_KEYS = {"ts", "kind", "epoch", "prec1", "prec5", "best_prec1"}  # :416


def _records(out):
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def straight_run(trainer_root, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("straight"))
    tr = ClassifierTrainer(trainer_root, output_dir=out, **TRAINER_KW)
    best = tr.fit()
    return out, tr, best


def test_fit_writes_jax_metrics_records_and_checkpoints(straight_run):
    out, tr, best = straight_run
    records = _records(out)
    train = [r for r in records if r["kind"] == "train"]
    evals = [r for r in records if r["kind"] == "eval"]
    assert {r["kind"] for r in records} == {"train", "eval"}
    assert all(set(r) == TRAIN_KEYS for r in train)
    assert all(set(r) == EVAL_KEYS for r in evals)
    assert [r["step"] for r in train] == list(range(1, 9))
    assert [r["epoch"] for r in evals] == [1, 2]
    assert all(np.isfinite(r["loss"]) for r in train)
    assert evals[-1]["best_prec1"] == best == tr.best_prec1
    # optax.scale_by_adam(0.9, 0.999, 1e-8) x (-lr): no weight decay; the
    # reference's lr * global_batch / 256
    group = tr.optimizer.param_groups[0]
    assert (group["betas"], group["eps"], group["weight_decay"]) == \
        ((0.9, 0.999), 1e-8, 0.0)
    assert tr.base_lr == 0.1 * 2 / 256
    assert train[0]["lr"] == pytest.approx(tr.base_lr / (5 * 4), rel=1e-6)
    for name in ("checkpoint.pth", "model_best.pth"):
        assert os.path.isfile(os.path.join(out, name))
    meta = json.load(open(os.path.join(out, "checkpoint.pth.meta.json")))
    assert meta["epoch"] == 1 and meta["step"] == 8


def test_mid_epoch_resume_is_bit_equal(straight_run, trainer_root, tmp_path):
    """Preempted during step 6 (epoch 2, batch 2) with a checkpoint after
    every step, then resumed: the same losses and the same final weights,
    Adam state and BN statistics, bit for bit."""
    out_a, tr_a, _ = straight_run
    out_b = str(tmp_path / "b")
    tr_b = ClassifierTrainer(trainer_root, output_dir=out_b,
                             checkpoint_every_steps=1, **TRAINER_KW)
    real, calls = tr_b.train_step, []

    def preemptible(state, u8, labels):
        if len(calls) == 5:
            raise RuntimeError("preempted")
        calls.append(1)
        return real(state, u8, labels)

    tr_b.train_step = preemptible
    with pytest.raises(RuntimeError, match="preempted"):
        tr_b.fit()
    ckpt = os.path.join(out_b, "checkpoint.pth")
    meta = json.load(open(ckpt + ".meta.json"))
    assert meta["mid_epoch"] and (meta["epoch"], meta["batch_index"],
                                  meta["step"]) == (1, 1, 5)
    out_c = str(tmp_path / "c")
    tr_c = ClassifierTrainer(trainer_root, output_dir=out_c, resume=ckpt,
                             **TRAINER_KW)
    assert (tr_c.start_epoch, tr_c._resume_skip, tr_c.state.step) == (1, 1, 5)
    tr_c.fit()
    losses_a = {r["step"]: r["loss"] for r in _records(out_a)
                if r["kind"] == "train"}
    losses_c = {r["step"]: r["loss"] for r in _records(out_c)
                if r["kind"] == "train"}
    assert sorted(losses_c) == [6, 7, 8]
    assert all(losses_c[s] == losses_a[s] for s in losses_c)
    for key, val in tr_a.model.state_dict().items():
        assert torch.equal(tr_c.model.state_dict()[key], val), key
    opt_a, opt_c = tr_a.optimizer.state_dict(), tr_c.optimizer.state_dict()
    for i, s in opt_a["state"].items():
        for name, t in s.items():
            assert torch.equal(opt_c["state"][i][name], t), (i, name)


def test_foreign_resumes_are_refused(trainer_root, tmp_path):
    ref = tmp_path / "reference.pth.tar"
    model = CSPDarknet53(2, width=0.25, depth=0.25)
    torch.save({"epoch": 3, "state_dict": model.state_dict(),
                "optimizer": {}}, ref)
    with pytest.raises(ValueError, match="BACKBONE_PRETRAINED"):
        ClassifierTrainer(trainer_root, output_dir=str(tmp_path / "o"),
                          resume=str(ref), **TRAINER_KW)
    # a JAX package .ckpt without the optimizer's state (JAX's own
    # classifier fails on it with a KeyError)
    jax_ckpt.save_checkpoint({"variables": {}, "meta": {"epoch": 0}},
                             is_best=False, output_dir=str(tmp_path))
    with pytest.raises(ValueError, match="holds no opt_state"):
        ClassifierTrainer(trainer_root, output_dir=str(tmp_path / "o"),
                          resume=str(tmp_path / "checkpoint.ckpt"),
                          **TRAINER_KW)


def test_evaluate_jax_checkpoint_gives_jax_precisions(jax_pair, trainer_root,
                                                      tmp_path):
    """-e on a JAX package .ckpt of the classifier: the port's prec1/prec5
    in float32 equal JAX's make_eval_step over the same val folder."""
    jax_ckpt.save_checkpoint({"variables": jax_pair["vars"],
                              "meta": {"epoch": 0}},
                             is_best=False, output_dir=str(tmp_path))
    loader = JaxDataLoader(jax_data.ImageFolderDataset(
        f"{trainer_root}/val", SIZE, 72, is_train=False), 6, shuffle=False)
    (imgs, target), = list(loader)
    n1, n5, total = (int(c) for c in jax_pair["eval_step"](
        jax_pair["vars"], jnp.asarray(imgs), jnp.asarray(target["label"]),
        jnp.asarray(target["batch_mask"])))
    assert total == 6
    kw = dict(TRAINER_KW, num_classes=CLASSES, crop_size=SIZE, val_size=72,
              batch_size=6)
    tr = ClassifierTrainer(trainer_root, output_dir=str(tmp_path / "o"),
                           resume=str(tmp_path / "checkpoint.ckpt"),
                           evaluate_only=True, **kw)
    assert tr.train_loader is None
    assert tr.fit(evaluate_only=True) == (100.0 * n1 / 6, 100.0 * n5 / 6)


def test_best_checkpoint_loads_as_detection_backbone(straight_run,
                                                     tmp_path):
    """model_best.pth through MODEL.BACKBONE_PRETRAINED into the detection
    Trainer (a strict load): its backbone equals the classifier's."""
    out, tr, _ = straight_run
    coco = str(tmp_path / "coco")
    make_fake_coco(coco, "train2017", n_images=4, seed=0)
    make_fake_coco(coco, "val2017", n_images=2, seed=1)
    _, cfg = small_cfgs()
    cfg["MODEL"]["BACKBONE_PRETRAINED"] = os.path.join(out, "model_best.pth")
    cfg["TRAIN"]["OUTPUT_DIR"] = str(tmp_path / "det")
    cfg["DATA"]["WORKERS"] = 0
    det = Trainer(cfg, coco, device="cpu")
    best = torch.load(os.path.join(out, "model_best.pth"),
                      weights_only=True)["variables"]
    got = det.model.backbone.state_dict()
    assert set(got) == {k[len("backbone."):] for k in best
                        if k.startswith("backbone.")}
    for key, val in got.items():
        assert torch.equal(val, best["backbone." + key]), key


# ---------------------------------------------------------------------------
# the CLI


def test_cli_on_cpu_writes_log_metrics_and_checkpoints(trainer_root,
                                                       tmp_path):
    out = str(tmp_path / "cli")
    try:
        darknet_pretrain.main([trainer_root, "--device", "cpu", "-b", "2",
                               "--epochs", "1", "--crop-size", "32",
                               "--val-size", "36", "--num-classes", "2",
                               "-j", "0", "--print-freq", "1",
                               "--output-dir", out])
    finally:
        setup_logging()
    written = set(os.listdir(out))
    assert {"stdout.log", "metrics.jsonl", "checkpoint.pth",
            "model_best.pth"} <= written
    log = open(os.path.join(out, "stdout.log")).read()
    assert "Prec@1" in log and "--transfer-layout s2d: no-op" in log
    kinds = [r["kind"] for r in _records(out)]
    assert kinds.count("train") == 4 and kinds.count("eval") == 1


def test_cli_without_a_card_fails(trainer_root, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(SystemExit, match="CUDA was requested"):
        darknet_pretrain.main([trainer_root, "--output-dir",
                               str(tmp_path / "x")])
    assert not (tmp_path / "x").exists()
