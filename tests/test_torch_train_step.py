"""The port's train step (parallel/train_step.py) against the JAX package's
``make_train_step`` on a one-device mesh, plus the parts of training the
JAX package holds with its own tests: BatchNorm's running variance, the
SPP max-pool gradient on ties, accumulation, EMA, the non-finite guard,
checkpoints, and resumed runs through the Trainer.

WIDTH = DEPTH = 0.25, float32, 64x64, SGD. Tolerances, each stated where
it is used, cover summation order only (oneDNN against XLA on the CPU).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from tests.fixtures import make_fake_coco
from tests.test_torch_helpers import nchw, small_cfgs
from yolov4_tpu.models import build_model as jax_build_model
from yolov4_tpu.models.yolov4 import init_variables
from yolov4_tpu.models.neck import maxpool_same as jax_maxpool_same
from yolov4_tpu.models.neck import maxpool_same_exact as jax_maxpool_exact
from yolov4_tpu.ops.loss import build_criterion as jax_build_criterion
from yolov4_tpu.optim import build_lr_schedule as jax_build_lr_schedule
from yolov4_tpu.optim import build_optimizer as jax_build_optimizer
from yolov4_tpu.parallel import create_mesh
from yolov4_tpu.parallel import create_train_state as jax_create_train_state
from yolov4_tpu.parallel import make_train_step as jax_make_train_step
from yolov4_tpu_torch.config import Config
from yolov4_tpu_torch.engine.trainer import Trainer
from yolov4_tpu_torch.models import build_model
from yolov4_tpu_torch.models.layers import BatchNorm2d
from yolov4_tpu_torch.models.neck import maxpool_same
from yolov4_tpu_torch.ops.loss import build_criterion
from yolov4_tpu_torch.optim import build_lr_schedule, build_optimizer
from yolov4_tpu_torch.parallel import create_train_state, make_train_step
from yolov4_tpu_torch.utils import checkpoint as ckpt_lib
from yolov4_tpu_torch.utils.convert import state_dict_from_jax

torch.set_num_threads(1)

TRAIN_CFG = {
    "OPTIMIZER": {"TYPE": "SGD", "LR": 0.01, "MOMENTUM": 0.9, "DECAY": 5e-4},
    "LR_SCHEDULER": {"TYPE": "MultiStepLR", "IS_WARMUP": True,
                     "WARMUP_EPOCH": 1},
}


def _labels(b=2):
    """Boxes in input pixels, no two on the same (scale, anchor, cell):
    the JAX package picks an unspecified winner there."""
    labels = np.zeros((b, 60, 5), np.float32)
    labels[0, 0] = [20, 30, 10, 12, 5]
    labels[0, 1] = [44, 12, 16, 20, 63]
    labels[0, 2] = [33, 40, 50, 36, 1]
    labels[1, 0] = [12, 50, 20, 8, 17]
    labels[1, 1] = [40, 24, 30, 44, 0]
    return labels


def _tree_to_torch(tree):
    return {k: v.numpy() for k, v in
            state_dict_from_jax({"params": jax.device_get(tree)}).items()}


@pytest.fixture(scope="module")
def jax_two_steps():
    """The JAX step (ACCUMULATION_STEPS 2) called twice on one batch: the
    first call only accumulates, the second applies SGD at lr(1).

    The weights are the reference init (BN scales ~ N(0, 0.01)), where a
    training run starts. With BN re-drawn to O(1) scales, as the eval
    tests do, train-mode gradients are so ill-conditioned at this size
    that the port's own float32 and float64 gradients differ by ~10%.

    The JAX model runs its plain stem (S2D_STEM false), the path the port
    implements: with its space-to-depth stem the JAX package's float32
    gradients of the stem and of stage 1's base conv are 1-3% off a
    float64 evaluation (the plain path: 1e-4)."""
    jcfg, cfg = small_cfgs()
    jcfg["MODEL"]["S2D_STEM"] = False
    jmodel = jax_build_model(jcfg)
    jvars = jax.device_get(init_variables(jmodel, jax.random.PRNGKey(0), 64))
    sd = state_dict_from_jax(jvars)
    for c in (jcfg, cfg):
        for section, values in TRAIN_CFG.items():
            c[section].update(values)
    rng = np.random.default_rng(1)
    imgs = rng.random((2, 64, 64, 3), dtype=np.float32)
    labels = _labels()
    tx = jax_build_optimizer(jcfg, jvars["params"])
    step = jax_make_train_step(
        jmodel, jax_build_criterion(jcfg), tx,
        jax_build_lr_schedule(jcfg, len_epoch=4),
        create_mesh(jax.devices()[:1]), accumulation_steps=2)
    state = jax_create_train_state(jvars, tx)
    first = step(state, jnp.asarray(imgs), jnp.asarray(labels))
    out = {"loss1": float(first.loss),
           "grads1": _tree_to_torch(first.accum_grads),
           "stats1": jax.device_get(first.batch_stats)}
    second = step(first, jnp.asarray(imgs), jnp.asarray(labels))
    out.update(loss2=float(second.loss),
               params2=_tree_to_torch(second.params),
               stats2=jax.device_get(second.batch_stats))
    return dict(cfg=cfg, sd=sd, imgs=imgs, labels=labels, jax=out)


@pytest.fixture(scope="module")
def port_two_steps(jax_two_steps):
    p = jax_two_steps
    model = build_model(p["cfg"], device="cpu", train=True)
    model.load_state_dict(p["sd"])
    opt = build_optimizer(p["cfg"], model)
    step = make_train_step(model, build_criterion(p["cfg"]), opt,
                           build_lr_schedule(p["cfg"], len_epoch=4),
                           accumulation_steps=2)
    state = create_train_state(model)
    imgs = torch.from_numpy(p["imgs"])
    labels = torch.from_numpy(p["labels"])
    state = step(state, imgs, labels)
    out = {"loss1": float(state.loss),
           "grads1": {n: q.grad.clone().numpy()
                      for n, q in model.named_parameters()},
           "sd1": {k: v.clone().numpy() for k, v in model.state_dict().items()}}
    state = step(state, imgs, labels)
    out.update(loss2=float(state.loss), step=state.step,
               sd2={k: v.clone().numpy()
                    for k, v in model.state_dict().items()},
               grads2=[q.grad for q in model.parameters()])
    return out


def _bn_stats(stats):
    return {k: v.numpy() for k, v in
            state_dict_from_jax({"batch_stats": stats}).items()
            if not k.endswith("num_batches_tracked")}


def _close_per_tensor(got, want, rel):
    """max |got - want| <= rel * max |want| for each tensor."""
    assert set(got) == set(want)
    for key, w in want.items():
        err = np.abs(got[key] - w).max()
        assert err <= rel * max(np.abs(w).max(), 1e-30), (key, err,
                                                          np.abs(w).max())


def test_loss_matches_jax(jax_two_steps, port_two_steps):
    # float32 sums over every cell of three scales
    for key in ("loss1", "loss2"):
        np.testing.assert_allclose(port_two_steps[key], jax_two_steps["jax"][key],
                                   rtol=1e-5)


def test_gradients_match_jax(jax_two_steps, port_two_steps):
    # the accumulated gradient (loss / 2) of every parameter; 1e-3 of each
    # tensor's largest entry: two conv backends through ~70 layers
    _close_per_tensor(port_two_steps["grads1"], jax_two_steps["jax"]["grads1"],
                      rel=1e-3)


def test_sgd_updated_parameters_match_jax(jax_two_steps, port_two_steps):
    sd2 = port_two_steps["sd2"]
    want = jax_two_steps["jax"]["params2"]
    got = {k: sd2[k] for k in want}
    before = {k: jax_two_steps["sd"][k].numpy() for k in want}
    # the update itself (params2 - params0), 1e-3 of its largest entry
    _close_per_tensor({k: got[k] - before[k] for k in want},
                      {k: want[k] - before[k] for k in want}, rel=1e-3)
    assert port_two_steps["step"] == 2
    # gradients are zeroed after the update
    assert all(g is None for g in port_two_steps["grads2"])


@pytest.mark.parametrize("which", ["1", "2"])
def test_bn_running_stats_match_jax(jax_two_steps, port_two_steps, which):
    """The running statistics after one and two train forwards. At the
    reference init most batch variances are ~1e-4, too small here for the
    unbiased update's n / (n - 1) to show; the test below holds that."""
    want = _bn_stats(jax_two_steps["jax"][f"stats{which}"])
    sd = port_two_steps[f"sd{which}"]
    for key, w in want.items():
        np.testing.assert_allclose(sd[key], w, rtol=1e-4, atol=1e-6,
                                   err_msg=key)


def test_bn_running_var_is_flax_biased_update():
    """One train forward of the port's BatchNorm against flax's BatchNorm
    and against torch's own (unbiased) update, which must differ."""
    x = np.random.default_rng(0).normal(1.0, 2.0, (2, 4, 4, 3)).astype(
        np.float32)                                               # n = 32
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                       epsilon=1e-5)
    variables = bn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    _, upd = bn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    want = np.asarray(upd["batch_stats"]["var"])
    ours = BatchNorm2d(3, eps=1e-5, momentum=0.1).train()
    torch_bn = torch.nn.BatchNorm2d(3, eps=1e-5, momentum=0.1).train()
    xt = nchw(x)
    ours(xt)
    torch_bn(xt)
    np.testing.assert_allclose(ours.running_var.numpy(), want, rtol=1e-6)
    biased = xt.var(dim=(0, 2, 3), unbiased=False)
    np.testing.assert_allclose(ours.running_var.numpy(),
                               (0.9 + 0.1 * biased).numpy(), rtol=1e-6)
    assert not np.allclose(torch_bn.running_var.numpy(), want, rtol=1e-4)
    assert int(ours.num_batches_tracked) == 1


def _tied_input():
    """Values on a coarse grid so that most pooling windows hold ties."""
    rng = np.random.default_rng(3)
    return rng.integers(0, 4, (2, 3, 9, 9)).astype(np.float32)


@pytest.mark.parametrize("size", [5, 9])
@pytest.mark.parametrize("exact", [False, True])
def test_maxpool_tie_gradient_matches_jax(size, exact):
    """EXACT_POOL_GRAD false (default): the gradient splits among tied
    maxima like the JAX package's ``maxpool_same``; true: all of it goes
    to the first maximum, like ``maxpool_same_exact`` and torch."""
    x = _tied_input()
    g = np.random.default_rng(4).normal(size=x.shape).astype(np.float32)
    jax_fn = jax_maxpool_exact if exact else jax_maxpool_same
    xj = jnp.asarray(x.transpose(0, 2, 3, 1))
    gj = jnp.asarray(g.transpose(0, 2, 3, 1))
    want = np.asarray(jax.grad(
        lambda v: jnp.vdot(jax_fn(v, size), gj))(xj)).transpose(0, 3, 1, 2)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = maxpool_same(xt, size, exact_grad=exact)
    (y * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), want, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(
        y.detach().numpy(),
        np.asarray(jax_fn(xj, size)).transpose(0, 3, 1, 2))


def test_default_maxpool_gradient_is_not_first_max_routing():
    """On a tied input the default backward differs from torch's own."""
    x = _tied_input()
    a = torch.from_numpy(x).requires_grad_(True)
    b = torch.from_numpy(x).requires_grad_(True)
    maxpool_same(a, 5).sum().backward()
    torch.nn.functional.max_pool2d(b, 5, 1, 2).sum().backward()
    assert not torch.allclose(a.grad, b.grad)
    torch.testing.assert_close(a.grad.sum(), b.grad.sum())  # same mass


def _small_step(accum=1, ema_decay=0.0, skip_nonfinite=False,
                optimizer="SGD"):
    cfg = Config.from_dict({"MODEL": {"WIDTH": 0.25, "DEPTH": 0.25,
                                      "COMPUTE_DTYPE": "float32"},
                            **TRAIN_CFG})
    cfg["OPTIMIZER"]["TYPE"] = optimizer
    model = build_model(cfg, device="cpu", train=True)
    opt = build_optimizer(cfg, model)
    step = make_train_step(model, build_criterion(cfg), opt,
                           build_lr_schedule(cfg, len_epoch=4),
                           accumulation_steps=accum, ema_decay=ema_decay,
                           skip_nonfinite=skip_nonfinite)
    state = create_train_state(model, ema=ema_decay > 0)
    rng = np.random.default_rng(0)
    imgs = torch.from_numpy(rng.random((2, 64, 64, 3), dtype=np.float32))
    return model, opt, step, state, imgs, torch.from_numpy(_labels())


def _params(model):
    return [p.detach().clone() for p in model.parameters()]


def test_images_to_input_keeps_float32_and_follows_float64():
    from yolov4_tpu_torch.parallel.train_step import images_to_input
    x = torch.from_numpy(np.random.default_rng(3).random((2, 8, 8, 3),
                                                         dtype=np.float32))
    nchw_view = x.permute(0, 3, 1, 2)
    got = images_to_input(x)
    assert got.dtype == torch.float32 and torch.equal(got, nchw_view)
    bf = x.to(torch.bfloat16)
    assert torch.equal(images_to_input(bf), bf.permute(0, 3, 1, 2).float())
    u8 = (x * 255).to(torch.uint8)
    assert torch.equal(images_to_input(u8),
                       u8.permute(0, 3, 1, 2).float() / 255.0)
    got = images_to_input(x.double())
    assert got.dtype == torch.float64 and torch.equal(got,
                                                      nchw_view.double())


def test_float64_step_stays_float64():
    """A float64 model and batch train in float64 end to end (decode,
    loss, the max-pool backward): what the card is held to against the CPU
    without float32's conditioning."""
    model, _, step, state, imgs, labels = _small_step(accum=1)
    model.double()
    p0 = _params(model)
    state = step(state, imgs.double(), labels)
    assert state.loss.dtype == torch.float64 and bool(torch.isfinite(
        state.loss))
    for p, before in zip(model.parameters(), p0):
        assert p.dtype == torch.float64 and not torch.equal(p, before)
    bn = model.backbone.stem.norm
    assert bn.running_mean.dtype == torch.float64
    # float32 from the same init and batch: close, but not the same sum
    _, _, step32, state32, _, _ = _small_step(accum=1)
    state32 = step32(state32, imgs, labels)
    assert abs(float(state32.loss) - float(state.loss)) \
        < 1e-5 * float(state.loss)
    assert float(state32.loss) != float(state.loss)


def test_accumulation_updates_every_k():
    model, _, step, state, imgs, labels = _small_step(accum=3)
    p0 = _params(model)
    for k in range(1, 3):
        state = step(state, imgs, labels)
        assert all(torch.equal(a, b) for a, b in zip(p0, _params(model)))
        assert sum(float(p.grad.abs().sum()) for p in model.parameters()) > 0
    state = step(state, imgs, labels)
    assert any(not torch.equal(a, b) for a, b in zip(p0, _params(model)))
    assert all(p.grad is None for p in model.parameters())
    assert state.step == 3


def test_ema_follows_decay_after_each_update():
    d = 0.9
    model, _, step, state, imgs, labels = _small_step(accum=2, ema_decay=d)
    names = [n for n, _ in model.named_parameters()]
    e0 = {n: state.ema_params[n].clone() for n in names}
    state = step(state, imgs, labels)          # accumulates only
    for n in names:
        assert torch.equal(state.ema_params[n], e0[n])
    state = step(state, imgs, labels)          # update, then EMA
    for n, p in model.named_parameters():
        torch.testing.assert_close(state.ema_params[n],
                                   d * e0[n] + (1 - d) * p.detach(),
                                   rtol=1e-6, atol=1e-7)


def test_skip_nonfinite_keeps_params_and_bn_buffers():
    # Adam, as the JAX package's guard test: an update from a zero
    # gradient sum is zero (SGD would still apply its weight decay)
    model, _, step, state, imgs, labels = _small_step(skip_nonfinite=True,
                                                      optimizer="ADAM")
    p0 = _params(model)
    b0 = [b.clone() for b in model.buffers()]
    bad = imgs.clone()
    bad[0, 0, 0, 0] = float("nan")
    state = step(state, bad, labels)
    assert not np.isfinite(float(state.loss))
    assert all(torch.equal(a, b) for a, b in zip(p0, _params(model)))
    for before, after in zip(b0, model.buffers()):
        assert torch.equal(before, after)
    state = step(state, imgs, labels)
    assert np.isfinite(float(state.loss))
    assert any(not torch.equal(a, b) for a, b in zip(p0, _params(model)))
    assert all(bool(torch.isfinite(b.float()).all()) for b in model.buffers())


def test_checkpoint_round_trip(tmp_path):
    model, opt, step, state, imgs, labels = _small_step()
    state = step(state, imgs, labels)
    bundle = {"variables": model.state_dict(), "opt_state": opt.state_dict(),
              "meta": {"epoch": 3, "step": state.step, "best_ap50": 0.5}}
    path = ckpt_lib.save_checkpoint(bundle, is_best=True,
                                    output_dir=str(tmp_path),
                                    meta=bundle["meta"])
    assert path.endswith("checkpoint.pth")
    assert (tmp_path / "model_best.pth").exists()
    assert json.load(open(path + ".meta.json"))["epoch"] == 3
    raw = ckpt_lib.load_checkpoint_raw(path)
    model2, opt2, *_ = _small_step()
    model2.load_state_dict(raw["variables"])
    opt2.load_state_dict(raw["opt_state"])
    for a, b in zip(model.state_dict().values(),
                    model2.state_dict().values()):
        assert torch.equal(a, b)
    for sa, sb in zip(opt.state_dict()["state"].values(),
                      opt2.state_dict()["state"].values()):
        assert torch.equal(sa["momentum_buffer"], sb["momentum_buffer"])
    # a .ckpt is read as the JAX package's msgpack tree, and a file that
    # holds no such tree (here a msgpack list) is refused
    (tmp_path / "x.ckpt").write_bytes(b"\x93\x01\x02\x03")
    with pytest.raises(ValueError, match="JAX package checkpoint"):
        ckpt_lib.load_checkpoint_raw(str(tmp_path / "x.ckpt"))


def _trainer_cfg(tmp_path, out_name, max_epochs):
    return Config.from_dict({
        "MODEL": {"WIDTH": 0.25, "DEPTH": 0.25, "COMPUTE_DTYPE": "float32"},
        "TRAIN": {"IMGSIZE": 64, "MAX_EPOCHS": max_epochs,
                  "OUTPUT_DIR": str(tmp_path / out_name)},
        "TEST": {"IMGSIZE": 64, "BATCH_SIZE": 2, "PRE_NMS_TOPK": 64,
                 "MAX_DETS": 10},
        "DATA": {"WORKERS": 0, "BATCH_SIZE": 4},
        "AUGMENTATION": {"IS_MOSAIC": False},
    })


def _train_records(out_dir):
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return {r["step"]: r for r in rows if r["kind"] == "train"}


@pytest.fixture(scope="module")
def coco_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("coco"))
    make_fake_coco(root, "train2017", n_images=12, seed=0)  # 3 steps/epoch
    make_fake_coco(root, "val2017", n_images=2, seed=1)
    return root


@pytest.fixture(scope="module")
def straight_run(coco_root, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("straight")
    cfg = _trainer_cfg(tmp, "a", max_epochs=2)
    trainer = Trainer(cfg, coco_root, device="cpu", print_freq=1)
    trainer.fit()
    assert trainer.state.step == 6
    return trainer, _train_records(cfg["TRAIN"]["OUTPUT_DIR"])


def _assert_same_run(trainer_a, rec_a, trainer_c, rec_c, steps):
    assert set(rec_c) == set(steps), sorted(rec_c)
    for s in steps:
        np.testing.assert_allclose(rec_a[s]["loss"], rec_c[s]["loss"],
                                   rtol=1e-6)
        np.testing.assert_allclose(rec_a[s]["lr"], rec_c[s]["lr"], rtol=1e-9)
    for (ka, a), (kc, c) in zip(trainer_a.model.state_dict().items(),
                                trainer_c.model.state_dict().items()):
        assert ka == kc
        assert torch.equal(a, c), ka


def test_resume_trajectory_matches_straight_run(tmp_path, coco_root,
                                                straight_run):
    """Two epochs straight == one epoch, save, a NEW Trainer resuming, one
    more epoch: the same losses, learning rates, parameters and BN
    statistics. Needs parameters, BN buffers, SGD momentum, the global
    step (warmup LR) and the loader's epoch order all restored."""
    trainer_a, rec_a = straight_run
    cfg_b = _trainer_cfg(tmp_path, "b", max_epochs=1)
    Trainer(cfg_b, coco_root, device="cpu", print_freq=1).fit()
    ckpt = os.path.join(cfg_b["TRAIN"]["OUTPUT_DIR"], "checkpoint.pth")
    cfg_c = _trainer_cfg(tmp_path, "c", max_epochs=2)
    trainer_c = Trainer(cfg_c, coco_root, resume=ckpt, device="cpu",
                        print_freq=1)
    assert trainer_c.start_epoch == 1 and trainer_c.state.step == 3
    trainer_c.fit()
    _assert_same_run(trainer_a, rec_a, trainer_c,
                     _train_records(cfg_c["TRAIN"]["OUTPUT_DIR"]), [4, 5, 6])


def test_preemption_mid_epoch_resume(tmp_path, coco_root, straight_run):
    """TRAIN.CHECKPOINT_EVERY_STEPS: a run killed during step 5 resumes
    from the rolling checkpoint of step 4 (epoch 2, batch 1) and
    reproduces steps 5-6 of the uninterrupted run."""
    trainer_a, rec_a = straight_run
    cfg_b = _trainer_cfg(tmp_path, "b", max_epochs=2)
    cfg_b["TRAIN"]["CHECKPOINT_EVERY_STEPS"] = 1
    trainer_b = Trainer(cfg_b, coco_root, device="cpu", print_freq=1)
    real_step, calls = trainer_b.train_step, 0

    def preemptible(state, imgs, labels):
        nonlocal calls
        if calls == 4:
            raise RuntimeError("preempted")
        calls += 1
        return real_step(state, imgs, labels)

    trainer_b.train_step = preemptible
    with pytest.raises(RuntimeError, match="preempted"):
        trainer_b.fit()
    ckpt = os.path.join(cfg_b["TRAIN"]["OUTPUT_DIR"], "checkpoint.pth")
    with open(ckpt + ".meta.json") as f:
        meta = json.load(f)
    assert meta["mid_epoch"] and meta["epoch"] == 1 \
        and meta["batch_index"] == 1 and meta["step"] == 4, meta
    cfg_c = _trainer_cfg(tmp_path, "c", max_epochs=2)
    trainer_c = Trainer(cfg_c, coco_root, resume=ckpt, device="cpu",
                        print_freq=1)
    assert trainer_c.start_epoch == 1 and trainer_c._resume_skip == 1
    assert trainer_c.state.step == 4
    trainer_c.fit()
    _assert_same_run(trainer_a, rec_a, trainer_c,
                     _train_records(cfg_c["TRAIN"]["OUTPUT_DIR"]), [5, 6])
