"""Data parallelism of the port on the CPU: process groups
(parallel/dist.py), the sharded loader, the train step over ranks, the
multi-process validate and the Trainer, against the JAX package where it
has the same function.

Ranks are spawned processes (tests/test_torch_parallel_worker.py) in a
gloo group that rendezvous through a file in the test's tmp_path, so that
parallel test workers never share a port; each group is joined within
SPAWN_LIMIT_S, and a rank that hangs fails its test. WIDTH = DEPTH = 0.25,
64x64, float32, one thread per process.
"""

import multiprocessing as mp
import os
import time

import jax
import numpy as np
import pytest
import torch

from tests.fixtures import make_fake_coco
from tests.test_torch_helpers import small_cfgs
from tests.test_torch_parallel_worker import gather_rows, oracle_validate, \
    run_rank
from yolov4_tpu.data.pipeline import DataLoader as JaxDataLoader
from yolov4_tpu.engine.evaluator import \
    _dedup_wrap_padding as jax_dedup_wrap_padding
from yolov4_tpu.models import build_model as jax_build_model
from yolov4_tpu.models.yolov4 import init_variables
from yolov4_tpu.ops.loss import build_criterion as jax_build_criterion
from yolov4_tpu.optim import build_lr_schedule as jax_build_lr_schedule
from yolov4_tpu.optim import build_optimizer as jax_build_optimizer
from yolov4_tpu.parallel import create_mesh
from yolov4_tpu.parallel import create_train_state as jax_create_train_state
from yolov4_tpu.parallel import make_train_step as jax_make_train_step
from yolov4_tpu.parallel.mesh import batch_sharding, replicated
from yolov4_tpu_torch.config import Config
from yolov4_tpu_torch.data.pipeline import DataLoader
from yolov4_tpu_torch.engine.evaluator import _dedup_wrap_padding
from yolov4_tpu_torch.engine.predictor import resolve_device
from yolov4_tpu_torch.models import build_model
from yolov4_tpu_torch.ops.loss import build_criterion
from yolov4_tpu_torch.optim import build_lr_schedule, build_optimizer
from yolov4_tpu_torch.parallel import create_train_state, dist, make_train_step
from yolov4_tpu_torch.parallel.train_step import aug_generator
from yolov4_tpu_torch.utils.convert import state_dict_from_jax
from yolov4_tpu_torch.utils.logging import get_logger, setup_logging
from yolov4_tpu_torch.utils.metrics import MetricsJSONL

torch.set_num_threads(1)

SPAWN_LIMIT_S = 240
WORLD = 2
# SGD at lr 0.1 without warmup: the update of the least-moved tensor stays
# thousands of times the float32 spacing of its parameters, so that 1e-3
# of it measures the step and not the rounding of p + update (at the
# warmup's lr 0.005 one spacing is 1.2e-3 of neck.pan.module2.4's update)
TRAIN_CFG = {
    "OPTIMIZER": {"TYPE": "SGD", "LR": 0.1, "MOMENTUM": 0.9, "DECAY": 5e-4},
    "LR_SCHEDULER": {"TYPE": "MultiStepLR", "IS_WARMUP": False},
}


class Spawned:
    """``world`` rank processes running one task of the worker module, all
    started at once; ``results()`` joins them within SPAWN_LIMIT_S and
    returns each rank's result."""

    def __init__(self, tmp, task, world=WORLD, **kwargs):
        self.tmp, self.task, self.world = str(tmp), task, world
        init_file = os.path.join(self.tmp, f"rendezvous.{task}")
        ctx = mp.get_context("spawn")
        self.procs = [ctx.Process(target=run_rank, args=(
            r, world, task, init_file, self.tmp, kwargs)) for r in range(world)]
        for p in self.procs:
            p.start()

    def results(self):
        deadline = time.monotonic() + SPAWN_LIMIT_S
        for p in self.procs:
            p.join(max(deadline - time.monotonic(), 0.0))
        hung = [r for r, p in enumerate(self.procs) if p.is_alive()]
        for p in self.procs:
            if p.is_alive():
                p.kill()
                p.join(10)
        assert not hung, f"{self.task}: ranks {hung} still running after " \
                         f"{SPAWN_LIMIT_S} s"
        codes = [p.exitcode for p in self.procs]
        assert codes == [0] * self.world, f"{self.task}: exit codes {codes}"
        return [torch.load(os.path.join(self.tmp, f"{self.task}.rank{r}.pt"),
                           weights_only=True) for r in range(self.world)]


# ---------------------------------------------------------------------------
# one process: the group helpers, logging and metrics gates


def test_one_process_without_environment(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert dist.init_distributed(device="cpu") is False
    assert (dist.rank(), dist.world_size(), dist.is_primary()) == (0, 1, True)
    assert dist.world_group() is None and dist.host_group() is None
    dist.lockstep("alone")                      # no group: returns at once
    assert dist.device_for_rank("cpu") == torch.device("cpu")


def test_coordinator_fills_master_address(monkeypatch):
    monkeypatch.setattr(dist.tdist, "init_process_group",
                        lambda *a, **k: pytest.fail("joined a group"))
    monkeypatch.setenv("MASTER_ADDR", "unset")
    monkeypatch.setenv("MASTER_PORT", "0")
    with pytest.raises(ValueError, match="host:port"):
        dist.init_distributed("node0", device="cpu")
    called = {}

    def fake_init(backend, **kwargs):
        called.update(backend=backend, **kwargs)
        raise RuntimeError("stop here")

    monkeypatch.setattr(dist.tdist, "init_process_group", fake_init)
    monkeypatch.setenv("RANK", "3")
    monkeypatch.setenv("WORLD_SIZE", "4")
    with pytest.raises(RuntimeError, match="stop here"):
        dist.init_distributed("node0.example:29512", device="cuda",
                              timeout_s=30)
    assert (os.environ["MASTER_ADDR"], os.environ["MASTER_PORT"]) == \
        ("node0.example", "29512")
    assert called["backend"] == "nccl" and called["init_method"] == "env://"
    assert (called["rank"], called["world_size"]) == (3, 4)
    assert called["timeout"].total_seconds() == 30


def test_resolve_device_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    for name in (None, "cuda", "cuda:1"):
        with pytest.raises(RuntimeError, match="CUDA was requested"):
            resolve_device(name)


def test_non_primary_logs_and_writes_nothing(tmp_path, capsys):
    try:
        setup_logging(process_index=1, output_dir=str(tmp_path / "log"))
        get_logger("x").warning("from rank 1")
        assert not (tmp_path / "log").exists()
        assert "from rank 1" not in capsys.readouterr().out
        setup_logging(process_index=0)
        get_logger("x").warning("from rank 0")
        assert "from rank 0" in capsys.readouterr().out
    finally:
        setup_logging()
    off = MetricsJSONL(str(tmp_path / "m" / "metrics.jsonl"), enabled=False)
    off.write({"kind": "x"})
    assert not (tmp_path / "m").exists()
    on = MetricsJSONL(str(tmp_path / "m" / "metrics.jsonl"))
    on.write({"kind": "x"})
    assert (tmp_path / "m" / "metrics.jsonl").read_text().count("\n") == 1


def test_aug_generator_keeps_rank0_stream_and_differs_by_rank():
    def draw(*args):
        return torch.rand(4, generator=aug_generator(torch.device("cpu"),
                                                     *args))
    assert torch.equal(draw(7, 3), draw(7, 3, 0))
    one = torch.Generator().manual_seed(hash((7, 3)) & 0x7FFFFFFFFFFFFFFF)
    assert torch.equal(draw(7, 3, 0), torch.rand(4, generator=one))
    assert not torch.equal(draw(7, 3, 0), draw(7, 3, 1))
    assert not torch.equal(draw(7, 3, 1), draw(7, 3, 2))
    assert torch.equal(draw(7, 3, 1), draw(7, 3, 1))


# ---------------------------------------------------------------------------
# (a) loader sharding, (b) dedup: the port's copies against the JAX package


class _Sized:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("n,count", [(10, 2), (11, 2), (7, 3)])
def test_loader_shards_match_jax(n, count, shuffle):
    seen = []
    for index in range(count):
        for drop_last in (False, True):
            kw = dict(batch_size=2, shuffle=shuffle, seed=5,
                      drop_last=drop_last, process_index=index,
                      process_count=count)
            ours, ref = DataLoader(_Sized(n), **kw), JaxDataLoader(_Sized(n),
                                                                   **kw)
            for epoch in (0, 3):
                ours.set_epoch(epoch)
                ref.set_epoch(epoch)
                np.testing.assert_array_equal(ours._local_indices(),
                                              ref._local_indices())
                assert len(ours) == len(ref)
                got = [(c.tolist(), s, z) for c, s, z in ours._batches()]
                want = [(c.tolist(), s, z) for c, s, z in ref._batches()]
                assert got == want
        seen += ours._local_indices().tolist()
    # every index at least once; the wrap-padding repeats fewer than count
    assert set(seen) == set(range(n)) and len(seen) - n < count


@pytest.mark.parametrize("case", ["one_wrap", "all_distinct", "many_ranks"])
def test_dedup_wrap_padding_matches_jax(case):
    def rows(ids, tag):
        return [{"image_id": i, "category_id": 1, "bbox": [tag, i, 1.0, 1.0],
                 "score": 0.5} for i in ids for _ in range(2)]

    per = {"one_wrap": [[1, 3, 5], [2, 4, 1]],
           "all_distinct": [[1, 3], [2, 4]],
           "many_ranks": [[1, 4, 7], [2, 5, 1], [3, 6, 2]]}[case]
    gathered = [(rows(ids, r), ids) for r, ids in enumerate(per)]
    got = _dedup_wrap_padding(gathered)
    assert got == jax_dedup_wrap_padding(gathered)
    assert sorted(got[1]) == sorted(set(sum(per, [])))
    assert all(r["bbox"][0] == min(k for k, ids in enumerate(per)
                                   if r["image_id"] in ids) for r in got[0])


# ---------------------------------------------------------------------------
# (c) the two-rank step against JAX's two-device mesh


def _labels4():
    """Boxes in input pixels for 4 images, no two on the same (scale,
    anchor, cell) of one image."""
    labels = np.zeros((4, 60, 5), np.float32)
    labels[0, :3] = [[20, 30, 10, 12, 5], [44, 12, 16, 20, 63],
                     [33, 40, 50, 36, 1]]
    labels[1, :2] = [[12, 50, 20, 8, 17], [40, 24, 30, 44, 0]]
    labels[2, :2] = [[30, 30, 24, 18, 2], [50, 50, 12, 10, 40]]
    labels[3, :3] = [[16, 16, 8, 8, 9], [40, 40, 40, 30, 11],
                     [48, 20, 14, 22, 70]]
    return labels


def _tree_to_torch(tree):
    return {k: v.numpy() for k, v in
            state_dict_from_jax({"params": jax.device_get(tree)}).items()}


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


def _worst_rel(got, want):
    return max(np.abs(got[k] - w).max() / max(np.abs(w).max(), 1e-30)
               for k, w in want.items())


@pytest.fixture(scope="module")
def two_rank_step(tmp_path_factory):
    """JAX's make_train_step on a two-device mesh, the reference init, plain
    stem, global batch 4, SGD, ACCUMULATION_STEPS 2, called twice; the
    port's over 2 gloo ranks of 2 images each (spawned first, so that
    both run at once); and the port's one-process step on all 4 images."""
    tmp = tmp_path_factory.mktemp("step")
    jcfg, cfg = small_cfgs()
    jcfg["MODEL"]["S2D_STEM"] = False
    for c in (jcfg, cfg):
        for section, values in TRAIN_CFG.items():
            c[section].update(values)
    jmodel = jax_build_model(jcfg)
    jvars = jax.device_get(init_variables(jmodel, jax.random.PRNGKey(0), 64))
    sd = {k: v.numpy() for k, v in state_dict_from_jax(jvars).items()}
    np.savez(tmp / "sd.npz", **sd)
    imgs = np.random.default_rng(1).random((4, 64, 64, 3), dtype=np.float32)
    labels = _labels4()
    cfg_raw = {"MODEL": dict(cfg["MODEL"]), "TEST": dict(cfg["TEST"]),
               **TRAIN_CFG}
    ranks = Spawned(tmp, "step", cfg_raw=cfg_raw, sd_path=str(tmp / "sd.npz"),
                    imgs=imgs, labels=labels)

    tx = jax_build_optimizer(jcfg, jvars["params"])
    mesh = create_mesh(jax.devices()[:2])
    step = jax_make_train_step(
        jmodel, jax_build_criterion(jcfg), tx,
        jax_build_lr_schedule(jcfg, len_epoch=4), mesh,
        accumulation_steps=2)
    # placed as the step returns them, so that both calls share one compile
    x = jax.device_put(imgs, batch_sharding(mesh))
    y = jax.device_put(labels, batch_sharding(mesh))
    first = step(jax.device_put(jax_create_train_state(jvars, tx),
                                replicated(mesh)), x, y)
    want = {"loss1": float(first.loss),
            "grads1": _tree_to_torch(first.accum_grads),
            "stats1": _bn_stats(jax.device_get(first.batch_stats))}
    second = step(first, x, y)
    want.update(loss2=float(second.loss),
                params2=_tree_to_torch(second.params),
                stats2=_bn_stats(jax.device_get(second.batch_stats)))

    model = build_model(cfg, device="cpu", train=True)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    one = make_train_step(model, build_criterion(cfg),
                          build_optimizer(cfg, model),
                          build_lr_schedule(cfg, len_epoch=4),
                          accumulation_steps=2)
    state = create_train_state(model)
    x, y = torch.from_numpy(imgs), torch.from_numpy(labels)
    state = one(state, x, y)
    global_batch = {"grads1": {n: p.grad.numpy().copy()
                               for n, p in model.named_parameters()},
                    "sd1": {k: v.numpy().copy()
                            for k, v in model.state_dict().items()}}
    one(state, x, y)
    global_batch["sd2"] = {k: v.numpy().copy()
                           for k, v in model.state_dict().items()}

    got = [{k: (({n: t.numpy() for n, t in v.items()})
                if isinstance(v, dict) else v) for k, v in r.items()}
           for r in ranks.results()]
    return dict(sd=sd, jax=want, ranks=got, global_batch=global_batch)


def test_two_rank_loss_matches_jax_mesh(two_rank_step):
    for r in two_rank_step["ranks"]:
        for key in ("loss1", "loss2"):
            np.testing.assert_allclose(r[key], two_rank_step["jax"][key],
                                       rtol=1e-5)


def test_two_rank_gradients_match_jax_mesh(two_rank_step):
    """The accumulated gradient after the first micro-step: still each
    rank's own sum in the port (DDP reduces in the update's backward), so
    its rank-mean against JAX's pmean'd sum, within 1e-3 of each tensor's
    largest entry."""
    ranks = two_rank_step["ranks"]
    mean = {n: (ranks[0]["grads1"][n] + ranks[1]["grads1"][n]) / 2
            for n in ranks[0]["grads1"]}
    _close_per_tensor(mean, two_rank_step["jax"]["grads1"], rel=1e-3)


def test_two_rank_update_matches_jax_mesh_and_ranks_agree(two_rank_step):
    want = two_rank_step["jax"]["params2"]
    before = two_rank_step["sd"]
    r0, r1 = two_rank_step["ranks"]
    _close_per_tensor({k: r0["sd2"][k] - before[k] for k in want},
                      {k: want[k] - before[k] for k in want}, rel=1e-3)
    for key in r0["sd2"]:
        np.testing.assert_array_equal(r0["sd2"][key], r1["sd2"][key],
                                      err_msg=key)
    assert r0["step"] == 2 and r0["grads_cleared"] and r1["grads_cleared"]


@pytest.mark.parametrize("which", ["1", "2"])
def test_two_rank_bn_stats_match_jax_mesh(two_rank_step, which):
    """Each rank's running statistics after one and two train forwards: the
    rank-mean of the per-replica updates, as JAX's pmean."""
    want = two_rank_step["jax"][f"stats{which}"]
    for r in two_rank_step["ranks"]:
        for key, w in want.items():
            np.testing.assert_allclose(r[f"sd{which}"][key], w, rtol=1e-4,
                                       atol=1e-6, err_msg=key)


def test_two_rank_step_is_not_the_global_batch_step(two_rank_step):
    """Per-replica BN is another function than BN over the global batch:
    the one-process step on all 4 images lands far outside the tolerance
    (1e-3 of each tensor's largest entry) that holds the two ranks to
    JAX's mesh, in the accumulated gradient and in the update. (The
    running statistics cannot tell them apart here: at the reference init
    the batch variances are ~1e-4 against running values of ~0.9.)"""
    ranks = two_rank_step["ranks"]
    one = two_rank_step["global_batch"]
    before = two_rank_step["sd"]
    mean = {n: (ranks[0]["grads1"][n] + ranks[1]["grads1"][n]) / 2
            for n in ranks[0]["grads1"]}
    assert _worst_rel(mean, one["grads1"]) > 1e-2
    params = two_rank_step["jax"]["params2"]
    assert _worst_rel({k: ranks[0]["sd2"][k] - before[k] for k in params},
                      {k: one["sd2"][k] - before[k] for k in params}) > 1e-2


# ---------------------------------------------------------------------------
# (d) skip_nonfinite, (e) validate: one spawn of 2 ranks each


def test_nonfinite_on_one_rank_skips_on_both(tmp_path):
    cfg_raw = {"MODEL": {"WIDTH": 0.25, "DEPTH": 0.25,
                         "COMPUTE_DTYPE": "float32"},
               "OPTIMIZER": {"TYPE": "ADAM", "LR": 0.01}}
    rng = np.random.default_rng(0)
    imgs = rng.random((WORLD, 2, 64, 64, 3), dtype=np.float32)
    labels = _labels4()[:2]
    r0, r1 = Spawned(tmp_path, "skip", cfg_raw=cfg_raw, imgs=imgs,
                     labels=labels).results()
    for r in (r0, r1):
        # Adam: a zero gradient sum moves nothing
        assert not np.isfinite(r["loss1"]) and r["step1"] == 1
        for key, before in r["sd0"].items():
            if key.endswith("num_batches_tracked"):
                continue
            assert torch.equal(r["sd1"][key], before), key
        assert np.isfinite(r["loss2"]) and r["step2"] == 2
        assert any(not torch.equal(r["sd2"][k], r["sd0"][k])
                   for k in r["sd0"])
    for key in r0["sd2"]:
        assert torch.equal(r0["sd2"][key], r1["sd2"][key]), key


@pytest.fixture(scope="module")
def val_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("coco_val"))
    make_fake_coco(root, "val2017", n_images=5, seed=3)   # odd: one wraps
    return root


def test_two_rank_validate_equals_one_process(tmp_path, val_root):
    rows_per_rank, ids_per_rank = [5, 2], [[11, 12, 13], [14, 11]]
    ranks = Spawned(tmp_path, "validate", root=val_root,
                    rows_per_rank=rows_per_rank,
                    ids_per_rank=ids_per_rank).results()
    ap, ap50 = oracle_validate(val_root)
    assert 0.0 < ap < ap50 < 1.0
    for r in ranks:
        assert (r["ap"], r["ap50"]) == pytest.approx((ap, ap50), abs=1e-12)
    # the gather: unequal row counts, the wrapped image 11 scored once
    want = _dedup_wrap_padding([
        (gather_rows(r, n, ids), ids)
        for r, (n, ids) in enumerate(zip(rows_per_rank, ids_per_rank))])
    for r in ranks:
        assert (r["rows"], r["ids"]) == want
    assert want[1] == [11, 12, 13, 14]


# ---------------------------------------------------------------------------
# (f) two-rank Trainer.fit through the CLI, then a two-rank resume


def _fit_cfg(max_epochs, out_dir=None):
    return {
        "MODEL": {"WIDTH": 0.25, "DEPTH": 0.25, "COMPUTE_DTYPE": "float32"},
        "TRAIN": {"IMGSIZE": 64, "MAX_EPOCHS": max_epochs,
                  "OUTPUT_DIR": out_dir or ""},
        "TEST": {"IMGSIZE": 64, "BATCH_SIZE": 2, "PRE_NMS_TOPK": 64,
                 "MAX_DETS": 10},
        "DATA": {"WORKERS": 0, "BATCH_SIZE": 2},
        "AUGMENTATION": {"IS_MOSAIC": False},
    }


@pytest.fixture(scope="module")
def fit_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("coco_fit"))
    make_fake_coco(root, "train2017", n_images=8, seed=0)   # 2 steps a rank
    make_fake_coco(root, "val2017", n_images=3, seed=1)
    return root


@pytest.fixture(scope="module")
def two_rank_fit(tmp_path_factory, fit_root):
    tmp = tmp_path_factory.mktemp("fit")
    ranks = Spawned(tmp, "fit", root=fit_root, cfg_raw=_fit_cfg(1),
                    out_dir=str(tmp)).results()
    return tmp, ranks


def test_two_rank_fit_writes_from_rank0_only(two_rank_fit):
    tmp, _ = two_rank_fit
    written = sorted(os.listdir(tmp / "r0"))
    for name in ("checkpoint.pth", "metrics.jsonl", "stdout.log"):
        assert name in written, written
    assert not (tmp / "r1").exists()
    log = (tmp / "r0" / "stdout.log").read_text()
    assert "2 process(es), this one rank 0" in log and "rank 1" not in log


def test_two_rank_fit_returns_the_same_ap_on_both(two_rank_fit):
    _, (r0, r1) = two_rank_fit
    assert (r0["ap"], r0["ap50"]) == (r1["ap"], r1["ap50"])
    assert 0.0 <= r0["ap"] <= r0["ap50"] <= 1.0


def test_two_rank_resume_keeps_ranks_equal(two_rank_fit, fit_root):
    tmp, _ = two_rank_fit
    out = tmp / "resumed"
    r0, r1 = Spawned(out.parent, "resume", root=fit_root,
                     cfg_raw=_fit_cfg(2, str(out)),
                     ckpt=str(tmp / "r0" / "checkpoint.pth")).results()
    assert r0["resumed_at"] == r1["resumed_at"] == (1, 2)
    assert r0["step"] == r1["step"] == 4
    for key in r0["sd"]:
        assert torch.equal(r0["sd"][key], r1["sd"][key]), key
    assert (out / "checkpoint.pth").exists()
