"""The port's optimizers and learning-rate schedules (optim/) against the
JAX package's: the LR trace, the weight-decay groups, and one Adam and
one SGD step (two, for the moments and momentum) against optax on the
same gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_helpers import small_cfgs
from yolov4_tpu.config import Config as JaxConfig
from yolov4_tpu.models import build_model as jax_build_model
from yolov4_tpu.models.yolov4 import init_variables
from yolov4_tpu.optim import build_lr_schedule as jax_build_lr_schedule
from yolov4_tpu.optim import build_optimizer as jax_build_optimizer
from yolov4_tpu.optim.optimizers import decay_mask as jax_decay_mask
from yolov4_tpu_torch.config import Config
from yolov4_tpu_torch.models import build_model
from yolov4_tpu_torch.optim import (build_lr_schedule, build_optimizer,
                                   decay_mask)
from yolov4_tpu_torch.utils.convert import state_dict_from_jax

torch.set_num_threads(1)

SCHEDULES = {
    "multistep_warmup": {"LR_SCHEDULER": {"TYPE": "MultiStepLR",
                                          "MILESTONES": [3, 5], "GAMMA": 0.1,
                                          "IS_WARMUP": True,
                                          "WARMUP_EPOCH": 2}},
    "multistep": {"LR_SCHEDULER": {"TYPE": "MultiStepLR",
                                   "MILESTONES": [1, 4], "GAMMA": 0.5,
                                   "IS_WARMUP": False}},
    "cosine_warmup": {"LR_SCHEDULER": {"TYPE": "CosineAnnealingLR",
                                       "IS_WARMUP": True, "WARMUP_EPOCH": 1,
                                       "MINIMAL_LR": 1e-6},
                      "TRAIN": {"MAX_EPOCHS": 6}},
    "cosine": {"LR_SCHEDULER": {"TYPE": "CosineAnnealingLR",
                                "IS_WARMUP": False, "MINIMAL_LR": 1e-5},
               "TRAIN": {"MAX_EPOCHS": 5}},
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_lr_trace_matches_jax(name):
    raw = SCHEDULES[name]
    want = jax_build_lr_schedule(JaxConfig.from_dict(raw), len_epoch=7)
    got = build_lr_schedule(Config.from_dict(raw), len_epoch=7)
    steps = np.arange(0, 7 * 7)
    w = np.asarray([float(want(jnp.asarray(s))) for s in steps])
    g = np.asarray([got(int(s)) for s in steps])
    # both in float32; XLA's cos against numpy's may differ in the last ulp
    np.testing.assert_allclose(g, w, rtol=1e-6)
    assert len(set(np.round(g, 12))) > 2   # the trace does change


def test_cosine_rejects_t_max_not_positive():
    raw = {"LR_SCHEDULER": {"TYPE": "CosineAnnealingLR", "IS_WARMUP": True,
                            "WARMUP_EPOCH": 5}, "TRAIN": {"MAX_EPOCHS": 5}}
    with pytest.raises(ValueError, match="MAX_EPOCHS > WARMUP_EPOCH"):
        build_lr_schedule(Config.from_dict(raw), len_epoch=3)


@pytest.fixture(scope="module")
def pair():
    """JAX variables of the small model and the port model holding them."""
    jcfg, cfg = small_cfgs()
    jvars = jax.device_get(init_variables(jax_build_model(jcfg),
                                          jax.random.PRNGKey(0), 64))
    model = build_model(cfg, device="cpu", train=True)
    model.load_state_dict(state_dict_from_jax(jvars))
    return jvars, model


@pytest.mark.parametrize("no_bias", [True, False])
@pytest.mark.parametrize("no_norm", [True, False])
def test_decay_groups_match_jax_decay_mask(pair, no_bias, no_norm):
    jvars, model = pair
    want = state_dict_from_jax(
        {"params": jax_decay_mask(jvars["params"], no_bias, no_norm)})
    got = decay_mask(model.named_parameters(), no_bias, no_norm)
    assert set(got) == set(want)
    for name, flag in got.items():
        assert bool(want[name].flatten()[0]) == flag, name
    cfg = Config.from_dict({"OPTIMIZER": {"TYPE": "SGD", "NO_BIAS": no_bias,
                                          "NO_NORM": no_norm}})
    groups = build_optimizer(cfg, model).param_groups
    decayed = {id(p) for g in groups if g["weight_decay"] > 0
               for p in g["params"]}
    for name, p in model.named_parameters():
        assert (id(p) in decayed) == got[name], name


@pytest.mark.parametrize("opt_type", ["ADAM", "SGD"])
def test_two_steps_match_optax(pair, opt_type):
    """Two updates at lr 0.01 from the same gradients: Adam's moments and
    SGD's momentum (with decay on the masked group) carry over."""
    jvars, model = pair
    raw = {"OPTIMIZER": {"TYPE": opt_type, "LR": 0.01, "MOMENTUM": 0.9,
                         "DECAY": 5e-4}}
    params = jvars["params"]
    tx = jax_build_optimizer(JaxConfig.from_dict(raw), params)
    rng = np.random.default_rng(0)
    grads = [jax.tree.map(lambda a: rng.normal(0, 1e-2, a.shape)
                          .astype(np.float32), params) for _ in range(2)]
    lr = 0.01
    opt_state = tx.init(params)
    jp = params
    for g in grads:
        updates, opt_state = tx.update(g, opt_state, jp)
        jp = jax.tree.map(lambda p, u: p - lr * u, jp, updates)
    want = state_dict_from_jax({"params": jax.device_get(jp)})

    port = build_model(Config.from_dict({"MODEL": {"WIDTH": 0.25,
                                                   "DEPTH": 0.25}}),
                       device="cpu", train=True)
    port.load_state_dict(model.state_dict())
    opt = build_optimizer(Config.from_dict(raw), port)
    for g in grads:
        tg = state_dict_from_jax({"params": g})
        for name, p in port.named_parameters():
            p.grad = tg[name].clone()
        opt.step()
    for name, p in port.named_parameters():
        # 1e-4 of the step size: optax takes Adam's bias correction
        # 1 - 0.999^t in float32 (3e-5 relative at t = 2), torch in float64
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=0, atol=1e-4 * lr, err_msg=name)
    moved = sum(float((p.detach() - q).abs().sum()) for p, q in
                zip(port.parameters(), model.parameters()))
    assert moved > 0
