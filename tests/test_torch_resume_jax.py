"""Resuming a JAX package training run in the port: ``train --resume`` and
``darknet_pretrain --resume`` on a ``.ckpt`` that the JAX package's
trainers wrote (utils/convert.opt_state_from_jax and bundle_from_jax, the
two trainers' ``_resume``), on the CPU, float32.

The detector runs at WIDTH = DEPTH = 0.25 and 64x64, the JAX model with
its plain stem (S2D_STEM false, the path the port implements), on a
one-device mesh: the JAX Trainer's batch is then the port's one-process
batch. One JAX run trains straight through an epoch of 12 micro-steps
(Adam, ACCUMULATION_STEPS 2, CHECKPOINT_EVERY_STEPS 3, EMA), keeping its
mid-epoch checkpoints, then resumes its own checkpoint at batch 3. The
classifier runs at full width (``darknet_pretrain`` has no width flag) and
crop 32. ``chip_smoke.write_jax_ckpt``, the writer of the card's phase 19,
is held here against flax and the JAX Trainer."""

import copy
import json
import os
import shutil

import flax.serialization as flax_serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from jax.sharding import NamedSharding, PartitionSpec

import chip_smoke
import yolov4_tpu.classify.trainer as jax_cls_trainer
import yolov4_tpu.engine.trainer as jax_trainer
from tests.fixtures import make_fake_coco
from tests.test_torch_classify import _write_folders
from yolov4_tpu.config import Config as JaxConfig
from yolov4_tpu.optim import build_optimizer as jax_build_optimizer
from yolov4_tpu.parallel import create_mesh
from yolov4_tpu.parallel import create_train_state as jax_create_train_state
from yolov4_tpu.utils import checkpoint as jax_ckpt
from yolov4_tpu.utils.torch_convert import export_state_dict
from yolov4_tpu_torch import darknet_pretrain
from yolov4_tpu_torch import train as train_cli
from yolov4_tpu_torch.classify.trainer import ClassifierTrainer
from yolov4_tpu_torch.config import Config
from yolov4_tpu_torch.engine.trainer import Trainer
from yolov4_tpu_torch.utils.convert import param_names_in_order

torch.set_num_threads(1)

TRAIN_IMAGES, BATCH = 24, 2          # 12 micro-steps an epoch
LR = 1e-3
# The port's losses after a resume against the JAX run they continue: the
# largest relative gap over the first RESUME_LOSSES micro-steps. Both sides
# start from the same float32 state and batches; oneDNN and XLA sum in
# other orders (~1e-7 a forward), and Adam's update, which divides by
# sqrt(nu), turns an element's float32 noise into a step of up to lr, so
# the gap grows with each update (5.6e-6 after the first at this size).
# A weights-only resume is 1e-3 off after its first update, and keeping the
# checkpoint's dropped partial gradient sum 9.5e-5.
RESUME_REL_TOL = 2e-5
RESUME_LOSSES = 4


def _raw_cfg(out_dir, opt_type="ADAM"):
    return {
        "MODEL": {"WIDTH": 0.25, "DEPTH": 0.25, "COMPUTE_DTYPE": "float32"},
        "OPTIMIZER": {"TYPE": opt_type, "LR": LR, "MOMENTUM": 0.9,
                      "DECAY": 5e-4},
        "LR_SCHEDULER": {"TYPE": "MultiStepLR", "IS_WARMUP": True,
                         "WARMUP_EPOCH": 1},
        "TRAIN": {"IMGSIZE": 64, "MAX_EPOCHS": 1, "OUTPUT_DIR": str(out_dir),
                  "ACCUMULATION_STEPS": 2, "CHECKPOINT_EVERY_STEPS": 3,
                  "EMA_DECAY": 0.9},
        "TEST": {"IMGSIZE": 64, "BATCH_SIZE": 2, "PRE_NMS_TOPK": 64,
                 "MAX_DETS": 10},
        "DATA": {"WORKERS": 0, "BATCH_SIZE": BATCH},
    }


def _jax_cfg(out_dir, opt_type="ADAM"):
    raw = _raw_cfg(out_dir, opt_type)
    raw["MODEL"]["S2D_STEM"] = False
    return JaxConfig.from_dict(raw)


def _one_device(mp, module):
    """The JAX trainer ``module`` on a one-device mesh, its loader batch
    one device's."""
    one = jax.devices()[:1]
    mp.setattr(module, "create_mesh", lambda: create_mesh(one))
    mp.setattr(jax, "local_devices", lambda *a, **k: one)


def _losses(out_dir, skip=0):
    """{micro-step: loss} of the train records of out_dir/metrics.jsonl
    after its first ``skip`` lines."""
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f][skip:]
    return {r["step"]: r["loss"] for r in rows if r["kind"] == "train"}


def _lines(out_dir):
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        return sum(1 for _ in f)


def _sgd_state(jtr, seed=5):
    """A JAX SGD train state after two updates from numpy gradients, its
    EMA apart from the parameters: what an SGD Trainer saves."""
    variables = {"params": jax.device_get(jtr.state.params),
                 "batch_stats": jax.device_get(jtr.state.batch_stats)}
    tx = jax_build_optimizer(_jax_cfg("", "SGD"), variables["params"])
    state = jax_create_train_state(variables, tx, ema=True)
    rng = np.random.default_rng(seed)
    params, opt_state = state.params, state.opt_state
    for _ in range(2):
        grads = jax.tree.map(lambda a: rng.normal(0, 1e-2, a.shape)
                             .astype(np.float32), params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = jax.tree.map(lambda p, u: p - 0.01 * u, params, updates)
    return state.replace(params=params, opt_state=opt_state,
                         step=jnp.asarray(5, jnp.int32),
                         ema_params=jax.tree.map(lambda p: p * 0.5,
                                                 params))


@pytest.fixture(scope="module")
def coco_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("coco"))
    make_fake_coco(root, "train2017", n_images=TRAIN_IMAGES, seed=0)
    make_fake_coco(root, "val2017", n_images=2, seed=1)
    return root


@pytest.fixture(scope="module")
def jax_run(coco_root, tmp_path_factory):
    """The JAX Trainer's straight epoch (its checkpoints at batches 3 and 6
    kept), then its own resume from batch 3 to the epoch's end; and
    an SGD state saved by the same Trainer's ``_save_mid_epoch``."""
    work = tmp_path_factory.mktemp("jax")
    out = work / "run"
    with pytest.MonkeyPatch.context() as mp:
        _one_device(mp, jax_trainer)
        jtr = jax_trainer.Trainer(_jax_cfg(out), coco_root, print_freq=1)
    # placed replicated, as each step returns it: one compile for both
    jtr.state = jax.device_put(jtr.state, NamedSharding(jtr.mesh,
                                                        PartitionSpec()))
    jtr.best_ap50, jtr.best_ap50_95 = 0.25, 0.125
    save = jtr._save_mid_epoch
    files = {}

    def saving(epoch, batch_index):
        save(epoch, batch_index)
        files[batch_index] = str(work / f"mid{batch_index}.ckpt")
        shutil.copyfile(out / "checkpoint.ckpt", files[batch_index])

    jtr._save_mid_epoch = saving
    jtr.train_epoch(0)
    straight = _losses(out)
    # a fresh Trainer's accumulator is zero, and so is this one's after
    # the epoch's last update: its own resume then runs as a new process's
    assert all(not np.any(a) for a in
               jax.tree.leaves(jax.device_get(jtr.state.accum_grads)))
    lines = _lines(out)
    jtr._save_mid_epoch = save
    jtr._resume(files[3])
    jtr.state = jax.device_put(jtr.state, NamedSharding(jtr.mesh,
                                                        PartitionSpec()))
    jtr.train_epoch(jtr.start_epoch)
    resumed = _losses(out, skip=lines)

    adam_state, jtr.state = jtr.state, _sgd_state(jtr)
    save(0, 5)
    files["sgd"] = str(work / "sgd.ckpt")
    shutil.copyfile(out / "checkpoint.ckpt", files["sgd"])
    jtr.state = adam_state
    return dict(files=files, straight=straight, resumed=resumed,
                trainer=jtr)


def _port(coco_root, out_dir, ckpt, opt_type="ADAM"):
    return Trainer(Config.from_dict(_raw_cfg(out_dir, opt_type)), coco_root,
                   resume=ckpt, device="cpu", print_freq=1)


def _port_losses(trainer):
    """The resumed epoch's {micro-step: loss}."""
    trainer.train_epoch(trainer.start_epoch)
    trainer.close()
    return _losses(trainer.output_dir)


def _rel_gap(got, want, steps):
    return max(abs(got[s] - want[s]) / abs(want[s]) for s in steps)


def _torch(arrays):
    return {k: torch.from_numpy(np.array(v, np.float32))
            for k, v in arrays.items()}


def _assert_exact_carry(trainer, raw, opt_type):
    """The port trainer's state against the file's arrays, bit for bit,
    after the JAX package's own layout change (export_state_dict)."""
    variables = raw["variables"]
    train = export_state_dict({"params": raw.get("raw_params",
                                                 variables["params"])})
    stats = export_state_dict({"batch_stats": variables["batch_stats"]})
    ema = export_state_dict({"params": variables["params"]})
    params = dict(trainer.model.named_parameters())
    buffers = dict(trainer.model.named_buffers())
    assert set(train) == set(params)
    for name, p in params.items():
        assert torch.equal(p.detach(), _torch(train)[name]), name
        # a resume in mid-window starts the partial gradient sum at zero
        assert p.grad is None, name
    for name, value in _torch(stats).items():
        assert torch.equal(buffers[name], value), name
    for name, value in _torch(ema).items():
        assert torch.equal(trainer.state.ema_params[name], value), name
    opt = raw["opt_state"]
    order = {id(p): n for n, p in params.items()}
    states = [(order[id(p)], trainer.optimizer.state[p])
              for g in trainer.optimizer.param_groups for p in g["params"]]
    assert len(states) == len(params)
    if opt_type == "ADAM":
        mu = _torch(export_state_dict({"params": opt["mu"]}))
        nu = _torch(export_state_dict({"params": opt["nu"]}))
        for name, s in states:
            assert torch.equal(s["exp_avg"], mu[name]), name
            assert torch.equal(s["exp_avg_sq"], nu[name]), name
            assert float(s["step"]) == int(opt["count"]), name
    else:
        assert opt["0"] == {"inner_state": {}}
        trace = _torch(export_state_dict({"params": opt["1"]["trace"]}))
        for name, s in states:
            assert torch.equal(s["momentum_buffer"], trace[name]), name
    meta = raw["meta"]
    assert (trainer.start_epoch, trainer._resume_skip, trainer.state.step,
            trainer.best_ap50, trainer.best_ap50_95) == (
        meta["epoch"], meta["batch_index"], meta["step"],
        meta["best_ap50"], meta["best_ap50_95"])


@pytest.mark.parametrize("opt_type", ["ADAM", "SGD"])
def test_resume_carries_the_file_exactly(jax_run, coco_root, tmp_path,
                                         opt_type):
    """(a) ADAM: the JAX run's checkpoint at batch 3 (inside an
    accumulation window, with an EMA); SGD: the state of two SGD updates,
    saved by the same Trainer."""
    path = jax_run["files"][3 if opt_type == "ADAM" else "sgd"]
    raw = jax_ckpt.load_checkpoint_raw(path)
    assert raw["meta"]["mid_epoch"]
    trainer = _port(coco_root, tmp_path / "p", path, opt_type)
    _assert_exact_carry(trainer, raw, opt_type)
    trainer.close()


@pytest.mark.parametrize("opt_type", ["ADAM", "SGD"])
def test_next_update_matches_optax(jax_run, coco_root, tmp_path, opt_type):
    """(b) From the carried state and one shared gradient, torch's update
    against optax's on the file's state, at test_torch_optim.py's
    tolerance (atol 1e-4 * lr)."""
    path = jax_run["files"][3 if opt_type == "ADAM" else "sgd"]
    raw = jax_ckpt.load_checkpoint_raw(path)
    params = raw.get("raw_params", raw["variables"]["params"])
    tx = jax_build_optimizer(_jax_cfg("", opt_type), params)
    opt_state = jax_ckpt.restore_onto(tx.init(params), raw["opt_state"])
    rng = np.random.default_rng(7)
    grads = jax.tree.map(lambda a: rng.normal(0, 1e-2, a.shape)
                         .astype(np.float32), params)
    lr = 0.01
    updates, _ = jax.jit(tx.update)(grads, opt_state, params)
    want = _torch(export_state_dict({"params": jax.device_get(
        jax.tree.map(lambda p, u: p - lr * u, params, updates))}))

    trainer = _port(coco_root, tmp_path / "p", path, opt_type)
    g = _torch(export_state_dict({"params": grads}))
    for name, p in trainer.model.named_parameters():
        p.grad = g[name].clone()
    for group in trainer.optimizer.param_groups:
        group["lr"] = lr
    trainer.optimizer.step()
    for name, p in trainer.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=0, atol=1e-4 * lr, err_msg=name)
    trainer.close()


def test_resume_at_a_window_boundary_follows_the_straight_run(
        jax_run, coco_root, tmp_path):
    """(c) The checkpoint at batch 6 closes an accumulation window: the
    port resumed from it continues the JAX run that went straight
    through, and a weights-only resume (the file's weights and data
    position, a fresh optimizer at step 0: a new run from the weights)
    fails the same tolerance."""
    path = jax_run["files"][6]
    steps = range(7, 7 + RESUME_LOSSES)
    full = _port_losses(_port(coco_root, tmp_path / "full", path))
    assert sorted(full) == list(range(7, 13))
    assert _rel_gap(full, jax_run["straight"], steps) <= RESUME_REL_TOL

    weights_only = _port(coco_root, tmp_path / "weights", path)
    weights_only.optimizer.state.clear()
    weights_only.state.step = 0
    losses = list(_port_losses(weights_only).values())
    renumbered = dict(zip(range(7, 13), losses))
    assert _rel_gap(renumbered, jax_run["straight"], steps) > RESUME_REL_TOL


def test_resume_inside_a_window_drops_the_partial_sum_as_jax_does(
        jax_run, coco_root, tmp_path):
    """(c) The checkpoint at batch 3 lies inside an accumulation window
    (ACCUMULATION_STEPS 2): the file has no partial gradient sum, so the
    JAX Trainer's resume updates at micro-step 4 from that step's gradient
    alone. The port's resume does the same: it follows the JAX resume, not
    the straight run, which kept the sum."""
    steps = range(4, 4 + RESUME_LOSSES)
    port = _port_losses(_port(coco_root, tmp_path / "p", jax_run["files"][3]))
    assert sorted(port) == sorted(jax_run["resumed"]) == list(range(4, 13))
    assert _rel_gap(port, jax_run["resumed"], steps) <= RESUME_REL_TOL
    assert _rel_gap(port, jax_run["straight"], steps) > RESUME_REL_TOL


def test_train_cli_resumes_a_jax_checkpoint(jax_run, coco_root, tmp_path):
    """``python -m yolov4_tpu_torch.train DATA -c CFG --resume
    checkpoint.ckpt`` on the CPU (the checkpoint at batch 6): the epoch's
    rest, its validation and the port's checkpoint, the first losses the
    JAX straight run's."""
    cfg = tmp_path / "small.yaml"
    with open(cfg, "w") as f:
        yaml.safe_dump(_raw_cfg(tmp_path / "cli"), f)
    train_cli.main([coco_root, "-c", str(cfg), "--device", "cpu",
                    "--print-freq", "1", "--resume", jax_run["files"][6]])
    losses = _losses(tmp_path / "cli")
    assert sorted(losses) == list(range(7, 13))
    assert _rel_gap(losses, jax_run["straight"],
                    range(7, 7 + RESUME_LOSSES)) <= RESUME_REL_TOL
    meta = json.loads((tmp_path / "cli" / "checkpoint.pth.meta.json")
                      .read_text())
    assert (meta["epoch"], meta["step"], meta["best_ap50"]) == (0, 12, 0.25)


# ---------------------------------------------------------------------------
# the classifier


CLS_KW = dict(batch_size=2, epochs=1, workers=0, crop_size=32, val_size=36,
              num_classes=2, seed=0)


@pytest.fixture(scope="module")
def jax_classifier(tmp_path_factory):
    """A JAX ClassifierTrainer's mid-epoch checkpoint (full width) after
    two steps, its Adam moments drawn with numpy, and the same bundle
    without opt_state."""
    work = tmp_path_factory.mktemp("cls")
    root = _write_folders(str(work / "imagenet"), [("train", 4),
                                                   ("val", 2)],
                          [(48, 56)], seed=2)
    with pytest.MonkeyPatch.context() as mp:
        _one_device(mp, jax_cls_trainer)
        jtr = jax_cls_trainer.ClassifierTrainer(
            root, output_dir=str(work / "out"), compute_dtype=jnp.float32,
            **CLS_KW)
    rng = np.random.default_rng(3)
    params = jax.device_get(jtr.state.params)
    draw = (lambda a: rng.normal(0, 1e-2, a.shape).astype(np.float32))
    opt_state = jtr.state.opt_state._replace(
        count=jnp.asarray(2, jnp.int32), mu=jax.tree.map(draw, params),
        nu=jax.tree.map(lambda a: np.square(draw(a)), params))
    jtr.state = jtr.state.replace(opt_state=opt_state,
                                  step=jnp.asarray(2, jnp.int32))
    jtr.best_prec1 = 37.5
    jtr._save_mid_epoch(0, 2)
    path = str(work / "cls.ckpt")
    shutil.copyfile(work / "out" / "checkpoint.ckpt", path)
    raw = jax_ckpt.load_checkpoint_raw(path)
    bare = str(work / "bare.ckpt")
    jax_ckpt.save_checkpoint({"variables": raw["variables"],
                              "meta": raw["meta"]}, False,
                             output_dir=str(work), filename="bare.ckpt")
    return dict(root=root, path=path, raw=raw, bare=bare)


def test_classifier_resumes_a_jax_checkpoint(jax_classifier, tmp_path):
    """(d) Parameters, BN statistics, Adam's moments and count, epoch,
    batch index, step and best prec1 bit-equal to the file's."""
    raw = jax_classifier["raw"]
    trainer = ClassifierTrainer(jax_classifier["root"],
                                output_dir=str(tmp_path / "o"),
                                resume=jax_classifier["path"],
                                compute_dtype=torch.float32, device="cpu",
                                **CLS_KW)
    want = _torch(export_state_dict(raw["variables"]))
    state = trainer.model.state_dict()
    for name, value in want.items():
        assert torch.equal(state[name], value), name
    mu = _torch(export_state_dict({"params": raw["opt_state"]["mu"]}))
    nu = _torch(export_state_dict({"params": raw["opt_state"]["nu"]}))
    for name, p in trainer.model.named_parameters():
        s = trainer.optimizer.state[p]
        assert torch.equal(s["exp_avg"], mu[name]), name
        assert torch.equal(s["exp_avg_sq"], nu[name]), name
        assert float(s["step"]) == 2.0
    meta = raw["meta"]
    assert (trainer.start_epoch, trainer._resume_skip, trainer.state.step,
            trainer.best_prec1) == (meta["epoch"], meta["batch_index"],
                                    meta["step"], 37.5)
    trainer.close()


def test_darknet_pretrain_cli_resumes_a_jax_checkpoint(jax_classifier,
                                                        tmp_path):
    """``python -m yolov4_tpu_torch.darknet_pretrain DIR --resume
    checkpoint.ckpt`` on the CPU: it re-enters the epoch at batch 2 and
    finishes it from step 2."""
    out = tmp_path / "cli"
    darknet_pretrain.main([
        jax_classifier["root"], "-b", "2", "--epochs", "1", "-j", "0",
        "--crop-size", "32", "--val-size", "36", "--num-classes", "2",
        "--opt-level", "O0", "--print-freq", "1", "--device", "cpu",
        "--output-dir", str(out), "--resume", jax_classifier["path"]])
    assert sorted(_losses(out)) == [3, 4]
    meta = json.loads((out / "checkpoint.pth.meta.json").read_text())
    assert (meta["epoch"], meta["step"]) == (0, 4)
    assert meta["best_prec1"] >= 37.5


# ---------------------------------------------------------------------------
# what is refused: never a fresh optimizer where the file holds a state


def _truncated(path, out):
    """A copy of ``path`` whose Adam ``mu`` lacks one leaf."""
    raw = jax_ckpt.load_checkpoint_raw(path)
    node = raw["opt_state"]["mu"]
    while isinstance(next(iter(node.values())), dict):
        node = next(iter(node.values()))
    del node[next(iter(node))]
    jax_ckpt.save_checkpoint(raw, False, output_dir=str(out),
                             filename="truncated.ckpt")
    return str(out / "truncated.ckpt")


@pytest.mark.parametrize("case", ["sgd_file_into_adam", "truncated_opt_state",
                                  "classifier_without_opt_state"])
def test_unmappable_checkpoints_are_refused(jax_run, jax_classifier,
                                            coco_root, tmp_path, case):
    """(e) Each raises, naming what does not map."""
    if case == "sgd_file_into_adam":
        with pytest.raises(ValueError, match=r"opt_state: the port's Adam "
                           r"needs optax's state with the keys"):
            _port(coco_root, tmp_path / "p", jax_run["files"]["sgd"])
    elif case == "truncated_opt_state":
        path = _truncated(jax_run["files"][3], tmp_path)
        with pytest.raises(ValueError, match=r"opt_state/mu: 1 parameter"
                           r"\(s\) of the model missing"):
            _port(coco_root, tmp_path / "p", path)
    else:
        with pytest.raises(ValueError, match="holds no opt_state"):
            ClassifierTrainer(jax_classifier["root"],
                              output_dir=str(tmp_path / "o"),
                              resume=jax_classifier["bare"], device="cpu",
                              **CLS_KW)


# ---------------------------------------------------------------------------
# chip_smoke.write_jax_ckpt: phase 19's writer against flax


def test_write_jax_ckpt_is_what_flax_reads_and_jax_resumes(
        jax_run, coco_root, tmp_path):
    """A JAX .ckpt resumed by the port, saved by the port as its .pth
    bundle, turned into the JAX layout by the chip phase's writer: flax
    reads it back leaf for leaf (keys, shapes, dtypes, bytes), the file's
    bytes are those the JAX package's save_checkpoint writes for that
    tree, and the JAX Trainer resumes it to the state it came from."""
    src = jax_run["files"][3]
    trainer = _port(coco_root, tmp_path / "p", src)
    meta = {"epoch": 0, "batch_index": 3, "mid_epoch": True,
            "step": trainer.state.step, "best_ap50": trainer.best_ap50,
            "best_ap50_95": trainer.best_ap50_95}
    bundle = trainer._bundle(meta)
    tree = chip_smoke.jax_bundle(bundle, param_names_in_order(
        trainer.optimizer, trainer.model))
    trainer.close()
    path = tmp_path / "w.ckpt"
    chip_smoke.write_jax_ckpt(path, tree)

    blob = path.read_bytes()
    assert blob == flax_serialization.msgpack_serialize(
        flax_serialization.to_state_dict(copy.deepcopy(tree)), in_place=True)
    back = flax_serialization.msgpack_restore(blob)
    want = jax_ckpt.load_checkpoint_raw(src)

    def same(a, b, where=""):
        assert isinstance(a, dict) == isinstance(b, dict), where
        if isinstance(a, dict):
            assert sorted(a) == sorted(b), where
            for k in a:
                same(a[k], b[k], f"{where}/{k}")
        else:
            a, b = np.asarray(a), np.asarray(b)
            assert (a.shape, a.dtype) == (b.shape, b.dtype), where
            assert a.tobytes() == b.tobytes(), where

    same(back, want)

    # the JAX Trainer's resume, on the run's own Trainer
    resumed = jax_run["trainer"]
    resumed._resume(str(path))
    for got, ref in ((resumed.state.params, want["raw_params"]),
                     (resumed.state.ema_params, want["variables"]["params"]),
                     (resumed.state.batch_stats,
                      want["variables"]["batch_stats"]),
                     (resumed.state.opt_state.mu, want["opt_state"]["mu"]),
                     (resumed.state.opt_state.nu, want["opt_state"]["nu"])):
        same(jax.device_get(got), ref)
    assert int(resumed.state.opt_state.count) == int(
        want["opt_state"]["count"])
    assert (int(resumed.state.step), resumed.start_epoch,
            resumed._resume_skip, resumed.best_ap50) == (3, 0, 3, 0.25)
