"""SyncBN of the port (models/layers.py::SyncBatchNorm2d, convert_sync_bn)
against flax's ``BatchNorm(axis_name=...)`` in the JAX package's
classifier step on a two-device CPU mesh (``bn_axis=DATA_AXIS``).

Two gloo ranks are spawned once (tests/test_torch_parallel_worker.py
``sync_bn_task``, through tests/test_torch_parallel.py's ``Spawned``):
two WIDTH 0.25 classifier steps with every BatchNorm synchronised, and a
single ConvBNAct's train forward on shards whose means differ, where the
global batch's variance holds the spread of the shard means and per-replica
BN's does not (tests/test_sync_bn.py's check). Float32, 64x64, one
thread per process.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax import shard_map
from PIL import Image
from jax.sharding import PartitionSpec as P

from tests.test_torch_helpers import spread_variables
from tests.test_torch_parallel import Spawned
from yolov4_tpu.classify import trainer as jax_trainer
from yolov4_tpu.models.darknet import CSPDarknet53 as JaxCSPDarknet53
from yolov4_tpu.models.layers import ConvBNAct as JaxConvBNAct
from yolov4_tpu.parallel import create_mesh
from yolov4_tpu.parallel.mesh import DATA_AXIS, batch_sharding, replicated
from yolov4_tpu.parallel.train_step import \
    create_train_state as jax_create_train_state
from yolov4_tpu_torch.classify.trainer import ClassifierTrainer
from yolov4_tpu_torch.models import layers
from yolov4_tpu_torch.models.darknet import CSPDarknet53
from yolov4_tpu_torch.models.layers import (BatchNorm2d, ConvBNAct,
                                            SyncBatchNorm2d, convert_sync_bn)
from yolov4_tpu_torch.utils.convert import state_dict_from_jax

torch.set_num_threads(1)

CLASSES, SIZE, BASE_LR = 7, 64, 0.05
# Adam's eps, as in tests/test_torch_classify.py: at 1e-8 an element whose
# gradient cancels to float32 noise moves a whole lr either way
ADAM_EPS = 1e-2
SHARD_MEANS = (-6.0, 6.0)


def _stats(sd):
    return {k: v for k, v in sd.items()
            if k.endswith(("running_mean", "running_var"))}


def _jax_sd(tree, collection):
    return {k: v.numpy() for k, v in state_dict_from_jax(
        {collection: jax.device_get(tree)}).items()
        if not k.endswith("num_batches_tracked")}


# the Trainer's validation over the ranks: 5 images, so that rank 1's
# shard wraps around to rank 0's first image
VAL_KW = dict(batch_size=2, workers=0, crop_size=32, val_size=36,
              num_classes=CLASSES, width=0.25, depth=0.25,
              compute_dtype=torch.float32, device="cpu")


def _val_root(root):
    rng = np.random.default_rng(5)
    for cls, n in (("alpha", 3), ("beta", 2)):
        d = root / "val" / cls
        d.mkdir(parents=True)
        for i in range(n):
            Image.fromarray(rng.integers(0, 255, (40, 48, 3), np.uint8)
                            ).save(d / f"{i}.jpg")
    return str(root)


@pytest.fixture(scope="module")
def synced(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sync_bn")
    val_root = _val_root(tmp / "imagenet")
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, (2, 4, SIZE, SIZE, 3), np.uint8)
    labels = np.array([[0, 3, 1, 4], [6, 2, 5, 0]], np.int32)
    conv_x = np.concatenate([rng.standard_normal((2, 8, 8, 3)) + m
                             for m in SHARD_MEANS]).astype(np.float32)

    jplain = JaxCSPDarknet53(num_classes=CLASSES, dtype=jnp.float32,
                             width=0.25, depth=0.25, s2d=False, wpack=False)
    init = jax.jit(lambda r, d: jplain.init({"params": r}, d, train=False))
    jvars = spread_variables(jax.device_get(init(
        jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)))), seed=3)
    np.savez(tmp / "sd.npz", **{k: v.numpy() for k, v in
                                state_dict_from_jax(jvars).items()})
    jconv = JaxConvBNAct(8, 3, 1, act="linear", dtype=jnp.float32)
    conv_vars = jax.device_get(jconv.init(jax.random.PRNGKey(1),
                                          conv_x[:1]))
    np.savez(tmp / "conv.npz", **{k: v.numpy() for k, v in
                                  state_dict_from_jax(conv_vars).items()})
    ranks = Spawned(tmp, "sync_bn", sd_path=str(tmp / "sd.npz"), imgs=imgs,
                    labels=labels, num_classes=CLASSES, base_lr=BASE_LR,
                    adam_eps=ADAM_EPS, conv_sd_path=str(tmp / "conv.npz"),
                    conv_x=np.ascontiguousarray(conv_x.transpose(0, 3, 1, 2)),
                    val_root=val_root, val_kw=VAL_KW)

    mesh = create_mesh(jax.devices()[:2])
    jmodel = JaxCSPDarknet53(num_classes=CLASSES, dtype=jnp.float32,
                             width=0.25, depth=0.25, s2d=False, wpack=False,
                             bn_axis=DATA_AXIS)

    def grad_body(params, batch_stats, u8, lab):
        def loss_fn(p):
            logits, _ = jmodel.apply(
                {"params": p, "batch_stats": batch_stats},
                jax_trainer.normalize_images(u8), train=True,
                mutable=["batch_stats"])
            return jax_trainer.smoothed_ce(logits, lab, CLASSES)
        return jax.lax.pmean(jax.grad(loss_fn)(params), DATA_AXIS)

    grads = jax.jit(shard_map(
        grad_body, mesh=mesh, in_specs=(P(), P(), P(DATA_AXIS), P(DATA_AXIS)),
        out_specs=P(), check_vma=False))
    put = lambda a: jax.device_put(jnp.asarray(a), batch_sharding(mesh))
    want = {"grads1": _jax_sd(grads(jvars["params"], jvars["batch_stats"],
                                    put(imgs[0]), put(labels[0])), "params")}
    tx = optax.scale_by_adam(b1=0.9, b2=0.999, eps=ADAM_EPS)
    step = jax_trainer.make_cls_train_step(
        jmodel, tx, jax_trainer.classifier_lr_schedule(BASE_LR, 1), mesh,
        CLASSES, size=SIZE)
    state = jax.device_put(jax_create_train_state(
        jax.tree.map(jnp.asarray, jvars), tx), replicated(mesh))
    want["losses"] = []
    for u8, lab in zip(imgs, labels):
        state = step(state, put(u8), put(lab))
        want["losses"].append(float(state.loss))
    want["sd2"] = {**_jax_sd(state.params, "params"),
                   **_jax_sd(state.batch_stats, "batch_stats")}

    def conv_stats(bn_axis):
        model = JaxConvBNAct(8, 3, 1, act="linear", dtype=jnp.float32,
                             bn_axis=bn_axis)

        def body(stats, xs):
            _, new = model.apply({"params": conv_vars["params"],
                                  "batch_stats": stats}, xs, train=True,
                                 mutable=["batch_stats"])
            return jax.tree.map(lambda s: jax.lax.pmean(s, DATA_AXIS),
                                new["batch_stats"])
        run = jax.jit(shard_map(body, mesh=mesh, in_specs=(P(), P(DATA_AXIS)),
                                out_specs=P(), check_vma=False))
        return _jax_sd(run(conv_vars["batch_stats"], put(conv_x)),
                       "batch_stats")

    want["conv_sync"] = conv_stats(DATA_AXIS)
    want["conv_replica"] = conv_stats(None)

    one = ConvBNAct(3, 8, 3, act="linear")
    with np.load(tmp / "conv.npz") as sd:
        one.load_state_dict({k: torch.from_numpy(sd[k]) for k in sd.files})
    one.train()
    one(torch.from_numpy(np.ascontiguousarray(conv_x.transpose(0, 3, 1, 2))))
    with np.load(tmp / "sd.npz") as sd:
        before = {k: torch.from_numpy(sd[k]) for k in sd.files}
    one_process_val = ClassifierTrainer(
        val_root, evaluate_only=True, resume=str(tmp / "sd.npz"),
        **VAL_KW).fit(evaluate_only=True)
    return dict(jax=want, ranks=ranks.results(), global_batch=_stats(
        one.state_dict()), before=before, val=one_process_val)


def test_every_batchnorm_is_synchronised(synced):
    n_bn = sum(isinstance(m, BatchNorm2d) for m in
               CSPDarknet53(CLASSES, 0.25, 0.25).modules())
    assert all(r["n_sync"] == n_bn > 30 for r in synced["ranks"])


def test_losses_match_jax_mesh(synced):
    """The rank-mean loss of each step, rtol 1e-5."""
    for r in synced["ranks"]:
        np.testing.assert_allclose(r["losses"], synced["jax"]["losses"],
                                   rtol=1e-5)


def test_gradients_match_jax_mesh(synced):
    """The first update's gradients (DDP's rank-mean, with the gradient
    through the statistics' all-reduce) against JAX's pmean'd gradients
    through flax's pmean'd statistics: within 1e-3 of each tensor's
    largest entry."""
    want = synced["jax"]["grads1"]
    for r in synced["ranks"]:
        assert set(r["grads1"]) == set(want)
        for key, w in want.items():
            err = np.abs(r["grads1"][key].numpy() - w).max()
            assert err <= 1e-3 * np.abs(w).max(), (key, err)


def test_parameters_after_two_steps_match_jax_mesh(synced):
    """Each parameter's change within 1e-3 of its tensor's largest."""
    want, before = synced["jax"]["sd2"], synced["before"]
    for r in synced["ranks"]:
        for key, w in want.items():
            if key.endswith(("running_mean", "running_var")):
                continue
            upd = w - before[key].numpy()
            err = np.abs(r["sd2"][key].numpy() - before[key].numpy()
                         - upd).max()
            assert err <= 1e-3 * np.abs(upd).max(), (key, err)


def test_running_stats_match_jax_mesh(synced):
    """The running mean and var after two synchronised forwards, rtol
    1e-4, atol 1e-6."""
    want = synced["jax"]["sd2"]
    for r in synced["ranks"]:
        for key, got in _stats(r["sd2"]).items():
            np.testing.assert_allclose(got.numpy(), want[key], rtol=1e-4,
                                       atol=1e-6, err_msg=key)


def test_ranks_agree_bit_for_bit(synced):
    r0, r1 = synced["ranks"]
    assert r0["losses"] == r1["losses"]
    for part in ("sd2", "conv_sync"):
        for key, val in r0[part].items():
            assert torch.equal(val, r1[part][key]), (part, key)
    for key, val in r0["grads1"].items():
        assert torch.equal(val, r1["grads1"][key]), key


def test_shards_with_different_means_give_the_global_variance(synced):
    """SyncBN's running statistics are the global batch's (one process on
    all four images, rtol 1e-5) and flax's (rtol 1e-4, atol 1e-6); per
    replica the running means agree but the variances lack the spread of
    the shard means."""
    r0 = synced["ranks"][0]
    sync, replica = _stats(r0["conv_sync"]), _stats(r0["conv_replica"])
    for key, got in sync.items():
        np.testing.assert_allclose(got.numpy(),
                                   synced["global_batch"][key].numpy(),
                                   rtol=1e-5, err_msg=key)
        np.testing.assert_allclose(got.numpy(),
                                   synced["jax"]["conv_sync"][key],
                                   rtol=1e-4, atol=1e-6, err_msg=key)
        np.testing.assert_allclose(replica[key].numpy(),
                                   synced["jax"]["conv_replica"][key],
                                   rtol=1e-4, atol=1e-6, err_msg=key)
    np.testing.assert_allclose(sync["norm.running_mean"],
                               replica["norm.running_mean"], rtol=1e-4,
                               atol=1e-5)
    rv_s, rv_p = sync["norm.running_var"], replica["norm.running_var"]
    assert (rv_s >= rv_p * 0.95).all() and rv_s.mean() > 1.5 * rv_p.mean()


def test_autocast_output_dtype_is_batchnorms(synced):
    """Under bfloat16 autocast a SyncBN ConvBNAct returns what a per-replica
    one does: the conv's bfloat16."""
    for r in synced["ranks"]:
        assert r["conv_sync_autocast_dtype"] == \
            r["conv_replica_autocast_dtype"] == "torch.bfloat16"


def test_two_rank_validation_equals_one_process(synced):
    """Each rank scores its shard of the val set (the wrap-padded copy of
    image 0 masked out) and the counts are summed over the ranks: both get
    the one-process prec1/prec5."""
    prec1, prec5 = synced["val"]
    # neither 0 nor 100 on both: a sixth (repeated) row would change them
    assert 0 < prec1 + prec5 < 200, synced["val"]
    assert all(r["val"] == synced["val"] for r in synced["ranks"])


def test_one_rank_warns_and_is_batchnorm():
    """No group (world size 1): SyncBatchNorm2d warns and computes
    BatchNorm2d's function; convert_sync_bn warns and changes nothing."""
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    layers.logger.addHandler(handler)
    level = layers.logger.level
    layers.logger.setLevel(logging.WARNING)
    try:
        sync = SyncBatchNorm2d(8)
        conv = ConvBNAct(3, 8, 3)
        assert convert_sync_bn(conv) is conv
    finally:
        layers.logger.removeHandler(handler)
        layers.logger.setLevel(level)
    assert len(records) == 2
    assert type(conv.norm) is BatchNorm2d
    plain = BatchNorm2d(8)
    with torch.no_grad():
        plain.weight.uniform_(0.5, 1.5)
        plain.bias.uniform_(-0.2, 0.2)
    sync.load_state_dict(plain.state_dict())
    x = torch.randn(4, 8, 5, 5) * 3 + 1
    for train in (True, False):
        sync.train(train)
        plain.train(train)
        assert torch.equal(sync(x), plain(x))
        for key, val in plain.state_dict().items():
            assert torch.equal(sync.state_dict()[key], val), key
