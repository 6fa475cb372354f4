"""The mesh Predictor (parallel/mesh.py, ``Predictor(mesh=...)``) on the
CPU, WIDTH = DEPTH = 0.25, 64x64, float32: one process shards each batch
over its replicas (threads), with the batch-global maxima taken over the
whole mesh.

A mesh of n CPU replicas is a list of n "cpu" devices. The mesh predictor
is held against the port's unsharded predictor on the same global batch
(float32, int8 at both spans, int8_static), against the JAX package's
mesh predictor on the 8-device CPU mesh that tests/conftest.py forces,
and on batches built so that a maximum taken per shard gives other rows
than the whole batch's (the NMS's class-offset span; the dynamic int8
activation abs-max). Then the serving runtime, export, validate and the
serve CLI on a mesh. Every thread wait has a timeout."""

import gc
import logging
import sys
import threading

import jax
import numpy as np
import pytest
import torch
import yaml

from tests.fixtures import make_fake_coco
from tests.test_torch_helpers import small_model_pair
from tests.test_torch_parallel_worker import LookupModel
from yolov4_tpu.engine.predictor import Predictor as JaxPredictor
from yolov4_tpu.parallel.mesh import create_mesh as jax_create_mesh
from yolov4_tpu_torch.config import Config
from yolov4_tpu_torch.data.coco import COCODataset
from yolov4_tpu_torch.data.pipeline import DataLoader
from yolov4_tpu_torch.data.transforms import Transform
from yolov4_tpu_torch.engine.evaluator import validate
from yolov4_tpu_torch.engine.predictor import Predictor
from yolov4_tpu_torch.ops.replica import replica_max
from yolov4_tpu_torch.parallel.mesh import (ReplicaError, ReplicaRunner,
                                            create_mesh)
from yolov4_tpu_torch.serve import ServingRuntime
from yolov4_tpu_torch.utils.export import export_serving

torch.set_num_threads(1)

SIZE = 64
TOPK = 64
TEST_KEYS = {"PRE_NMS_TOPK": TOPK, "MAX_DETS": 50, "CONFTHRE": 0.05,
             "NMSTHRE": 0.45}
INFO = (SIZE, SIZE, SIZE, SIZE)  # identity unmap
TIMEOUT = 120
# The mesh against the unsharded predictor on the same batch, in each mode
# below: each replica
# runs the unsharded program's operations on its rows, with the same
# global maxima, and on the CPU a row's arithmetic does not depend on how
# many rows share the call; so the rows must be equal to the bit.
MODES = {"float32": {}, "int8-late": {"QUANT": "int8"},
         "int8-full": {"QUANT": "int8", "QUANT_SPAN": "full"},
         "int8_static": {"QUANT": "int8_static"},
         # K2's plain version on the CPU; the replicas share one model
         "pallas_csp": {"PALLAS_CSP": True}}


@pytest.fixture(scope="module")
def pair():
    # seed 9 / head_scale 0.5: tests/test_torch_predictor.py's weights,
    # whose score gaps lie far beyond the two frameworks' difference
    jcfg, cfg, jmodel, jvars, sd = small_model_pair(seed=9, head_scale=0.5)
    for c in (jcfg, cfg):
        c["TEST"].update(TEST_KEYS)
    return dict(jcfg=jcfg, cfg=cfg, jvars=jvars, sd=sd)


def _cfg(base, **model_over):
    raw = {k: dict(v) for k, v in base.items()}
    raw["MODEL"].update(model_over)
    return Config.from_dict(raw)


def _images(seed=0, n=8):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (n, SIZE, SIZE, 3), np.uint8)


def _cpu_mesh(n):
    return create_mesh(["cpu"] * n)


def _assert_same_rows(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# --------------------------------------------------------------------------
# the mesh

def test_create_mesh_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        create_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        create_mesh(["cuda:0", "cuda:0"])
    mesh = create_mesh(["cpu", torch.device("cpu")])
    assert mesh.devices == (torch.device("cpu"),) * 2
    assert mesh.distinct_devices == (torch.device("cpu"),)
    with pytest.raises(ValueError):
        create_mesh([])


def test_shards_are_contiguous_rows_in_mesh_order():
    mesh = _cpu_mesh(4)
    assert mesh.size == 4
    assert mesh.shards(8) == [slice(0, 2), slice(2, 4), slice(4, 6),
                              slice(6, 8)]
    assert [mesh.round_batch(b) for b in (1, 4, 6, 8, 9)] == [4, 4, 8, 8, 12]
    with pytest.raises(ValueError):
        mesh.shards(6)


def test_replica_max_under_contention():
    """More replicas than cores, a short switch interval: every replica
    gets every call's global max (a lost or stale slot would give one
    replica's own value), and outside a run the value comes back as it
    is."""
    n, calls = 16, 200
    mesh = _cpu_mesh(n)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def work(rank):
            return [float(replica_max(torch.tensor(float(rank * calls + i))))
                    for i in range(calls)]
        got = ReplicaRunner(mesh).run(work)
    finally:
        sys.setswitchinterval(old)
    want = [float((n - 1) * calls + i) for i in range(calls)]
    assert got == [want] * n
    assert float(replica_max(torch.tensor(3.0))) == 3.0


def test_a_failing_replica_releases_the_others():
    """One replica raises before its first maximum: the others, waiting
    for their turn or for its value, stop and its exception reaches the
    caller."""
    runner = ReplicaRunner(_cpu_mesh(3))

    def work(rank):
        if rank == 1:
            raise KeyError("replica 1 failed")
        return replica_max(torch.tensor(1.0))

    done = []
    t = threading.Thread(target=lambda: done.append(
        pytest.raises(KeyError, runner.run, work)), daemon=True)
    t.start()
    t.join(TIMEOUT)
    assert not t.is_alive() and done

    def uneven(rank):
        for _ in range(2 if rank == 0 else 1):
            replica_max(torch.tensor(float(rank)))

    with pytest.raises(ReplicaError, match="different number"):
        runner.run(uneven)
    # the runner's threads outlive a failed run
    assert runner.run(lambda rank: rank) == [0, 1, 2]


def test_runner_threads_persist_and_end_with_the_runner(pair):
    """One thread per replica for the runner's life (its per-thread state
    is kept between runs); collecting the runner ends them. A mesh
    predictor holds its runner, and its threads must not hold the
    predictor: collecting the predictor ends them too."""
    runner = ReplicaRunner(_cpu_mesh(2))
    first = runner.run(lambda rank: threading.get_ident())
    assert runner.run(lambda rank: threading.get_ident()) == first
    threads = [t for t in threading.enumerate() if t.ident in first]
    assert len(threads) == 2
    del runner
    pred = Predictor(pair["cfg"], state_dict=pair["sd"], batch_size=2,
                     mesh=_cpu_mesh(2))
    before = set(threading.enumerate())
    pred(_images(0, 2))
    threads += [t for t in set(threading.enumerate()) - before
                if t.name.startswith("replica")]
    assert len(threads) == 4
    del pred
    gc.collect()
    for t in threads:
        t.join(TIMEOUT)
        assert not t.is_alive()


def test_replica_and_device_modules_import_nothing_of_the_package():
    """ops/replica.py and utils/device.py are leaves: the model's layers and
    the postprocess import replica_max, the mesh and the Predictor the
    device rule, and neither leaf reaches back into them."""
    import ast
    import pathlib
    root = pathlib.Path(__file__).resolve().parent.parent
    for rel in ("yolov4_tpu_torch/ops/replica.py",
                "yolov4_tpu_torch/utils/device.py"):
        tree = ast.parse((root / rel).read_text())
        names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                 for a in n.names]
        names += [n.module or "" for n in ast.walk(tree)
                  if isinstance(n, ast.ImportFrom)]
        assert names and not [m for m in names
                              if m.startswith("yolov4_tpu")], (rel, names)


# --------------------------------------------------------------------------
# (a) the mesh against the unsharded predictor; (e) the batch rounded up

@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n", (2, 4))
def test_mesh_matches_unsharded(pair, n, mode):
    cfg = _cfg(pair["cfg"], **MODES[mode])
    images = _images(1)
    want = Predictor(cfg, state_dict=pair["sd"], batch_size=8,
                     device="cpu")(images)
    mesh = Predictor(cfg, state_dict=pair["sd"], batch_size=8,
                     mesh=_cpu_mesh(n))
    assert mesh.mesh.size == n and mesh.batch_size == 8
    got = mesh(images)
    assert got[0].shape == (8, 50, 7) and 0 < got[1].sum() < got[1].size
    _assert_same_rows(got, want)


def test_batch_rounds_up_to_whole_rows_per_replica(pair):
    mesh = Predictor(pair["cfg"], state_dict=pair["sd"], batch_size=6,
                     mesh=_cpu_mesh(4))
    assert mesh.batch_size == 8
    images = _images(2, 6)
    got = mesh(images)
    assert got[0].shape == (6, 50, 7)
    want = Predictor(pair["cfg"], state_dict=pair["sd"], batch_size=8,
                     device="cpu")(images)
    _assert_same_rows(got, want)
    # a one-replica mesh is its device alone
    one = Predictor(pair["cfg"], state_dict=pair["sd"], batch_size=6,
                    mesh=_cpu_mesh(1))
    assert one.mesh is None and one.batch_size == 6
    with pytest.raises(ValueError, match="device or mesh"):
        Predictor(pair["cfg"], batch_size=6, mesh=_cpu_mesh(2), device="cpu")
    with pytest.raises(ValueError, match="replicas"):
        Predictor(pair["cfg"], batch_size=6, mesh=_cpu_mesh(2),
                  model={torch.device("cuda", 0): one.model})


# --------------------------------------------------------------------------
# (b) against the JAX package's mesh predictor

def test_mesh_matches_jax_mesh(pair):
    """JAX's mesh Predictor over the conftest's 8 CPU devices (its batch of
    2 rounds up to 8) against the port's over 4 replicas at batch 8: the
    same global batch, padding included. Tolerances: those of
    tests/test_torch_predictor.py::test_predictor_matches_jax, on the same
    weights and images."""
    assert len(jax.devices()) == 8
    images = np.random.default_rng(2).integers(0, 256, (2, SIZE, SIZE, 3),
                                               dtype=np.uint8)
    jpred = JaxPredictor(pair["jcfg"], variables=pair["jvars"], img_size=SIZE,
                         batch_size=2, mesh=jax_create_mesh())
    assert jpred.batch_size == 8
    jdet, jvalid = jpred(images)
    det, valid = Predictor(pair["cfg"], state_dict=pair["sd"], batch_size=8,
                           mesh=_cpu_mesh(4))(images)
    assert det.shape == (2, 50, 7)
    np.testing.assert_array_equal(valid, jvalid)
    assert 0 < valid.sum() < valid.size
    np.testing.assert_allclose(det[..., :4], jdet[..., :4], rtol=1e-4,
                               atol=1e-3)
    np.testing.assert_allclose(det[..., 4:6], jdet[..., 4:6], atol=1e-5)
    np.testing.assert_array_equal(det[..., 6], jdet[..., 6])


# --------------------------------------------------------------------------
# (c) shards whose own maxima would give other rows

def _span_case(n_boxes=64, classes=80):
    """Predictions of 8 images (ids 1-8): the first four with boxes ~3e5
    px from the origin, the last four with overlapping boxes inside 64 px.
    The whole batch's class-offset span (~6e5) puts the small boxes of
    class 79 near 5e7, where float32's spacing is 4 px, and so changes
    their IoUs: the NMS keeps other boxes than under their own shard's
    span (~130)."""
    rng = np.random.default_rng(5)
    preds = np.zeros((9, n_boxes, 5 + classes), np.float32)
    for i in range(1, 9):
        far = i <= 4
        centre = rng.uniform(2.9e5, 3.1e5, (n_boxes, 2)) if far else \
            rng.uniform(20, 44, (n_boxes, 2))
        wh = rng.uniform(8, 16, (n_boxes, 2))
        preds[i, :, :4] = np.concatenate([centre, wh], -1)
        preds[i, :, 4] = rng.uniform(0.3, 1.0, n_boxes)
        cls = rng.integers(classes - 4, classes, n_boxes)
        preds[i, np.arange(n_boxes), 5 + cls] = rng.uniform(0.5, 1.0,
                                                            n_boxes)
    images = np.zeros((8, SIZE, SIZE, 3), np.uint8)
    images[:, 0, 0, 0] = np.arange(1, 9)
    return LookupModel(torch.from_numpy(preds)), images


def test_span_is_taken_over_the_whole_mesh(pair):
    model, images = _span_case()
    cfg = _cfg(pair["cfg"])

    def predictor(batch, **kw):
        return Predictor(cfg, model=model, batch_size=batch, **kw)

    full = predictor(8, device="cpu")(images)
    shard = predictor(4, device="cpu")(images[4:])
    # the case is one where the shard's own span gives other rows
    assert not np.array_equal(shard[1], full[1][4:])
    got = predictor(8, mesh=_cpu_mesh(2))(images)
    _assert_same_rows(got, full)


@pytest.mark.parametrize("span", ("late", "full"))
def test_int8_amax_is_taken_over_the_whole_mesh(pair, span):
    """Bright noise in the first shard, dark images (values 0-7) in the
    second: the second shard's own activation abs-max is far smaller than
    the batch's. In float32 the dark shard alone gives the full batch's
    rows (so the span does not tell them apart); in int8 it does not."""
    images = _images(3)
    images[4:] //= 32
    sd = pair["sd"]

    def predictor(batch, **over):
        return Predictor(_cfg(pair["cfg"], **over), state_dict=sd,
                         batch_size=batch, device="cpu")

    _assert_same_rows(predictor(4)(images[4:]),
                      tuple(o[4:] for o in predictor(8)(images)))
    int8 = dict(QUANT="int8", QUANT_SPAN=span)
    full = predictor(8, **int8)(images)
    shard = predictor(4, **int8)(images[4:])
    assert not np.array_equal(shard[0], full[0][4:])
    got = Predictor(_cfg(pair["cfg"], **int8), state_dict=sd, batch_size=8,
                    mesh=_cpu_mesh(2))(images)
    _assert_same_rows(got, full)


# --------------------------------------------------------------------------
# (d) int8_static calibration on the mesh

@pytest.mark.parametrize("n", (2, 4))
def test_int8_static_calibration_on_mesh_gives_unsharded_scales(pair, n):
    cfg = _cfg(pair["cfg"], QUANT="int8_static")
    images = _images(4)
    images[4:] //= 32   # shards of different ranges
    plain = Predictor(cfg, state_dict=pair["sd"], batch_size=8,
                      device="cpu")
    mesh = Predictor(cfg, state_dict=pair["sd"], batch_size=8,
                     mesh=_cpu_mesh(n))
    mesh.warmup()
    assert mesh.quant_state is None  # warmup's seed scales stay private
    plain.calibrate(images)
    mesh.calibrate(images)
    want, got = plain.quant_state, mesh.quant_state
    assert set(got) == set(want) and len(want) > 10
    for site, entry in want.items():
        for key in ("amax", "wq", "sw"):
            assert torch.equal(got[site][key], entry[key]), (site, key)
    _assert_same_rows(mesh(images), plain(images))


# --------------------------------------------------------------------------
# (f) serving, (g) export, (h) validate, (i) the CLI

def test_serving_runtime_on_mesh_matches_direct_predictor(pair):
    """The counterpart of tests/test_serve.py::
    test_mesh_sharded_serving_matches_single_device: buckets on a
    two-replica mesh, batch 3 rounded to 4, the buckets sharing the
    replicas' weights; every response equal to the direct unsharded
    predictor's rows on the same batch."""
    mesh = _cpu_mesh(2)
    rt = ServingRuntime(pair["cfg"], state_dict=pair["sd"], sizes=[SIZE, 32],
                        batch_size=3, max_wait_ms=300.0, conf_thre=0.05,
                        mesh=mesh)
    preds = {s: b.predictor for s, b in rt.buckets.items()}
    assert all(p.mesh is mesh and p.batch_size == 4 for p in preds.values())
    assert preds[SIZE].replicas[torch.device("cpu")] is \
        preds[32].replicas[torch.device("cpu")]
    rt.start(warmup=True)
    images = _images(9, 4)
    try:
        bucket = rt.buckets[SIZE]
        assert bucket.batch_size == 4
        futs = [bucket.submit_canvas(images[i], INFO) for i in range(4)]
        got = [f.result(timeout=TIMEOUT) for f in futs]
    finally:
        rt.close()
    dets, valid = Predictor(pair["cfg"], state_dict=pair["sd"], batch_size=4,
                            conf_thre=0.05, device="cpu")(images)
    assert sum(g.boxes.shape[0] for g in got) > 0
    for i in range(4):
        d = dets[i][valid[i]]
        np.testing.assert_array_equal(got[i].boxes, d[:, :4])
        np.testing.assert_array_equal(got[i].scores, d[:, 4] * d[:, 5])
        np.testing.assert_array_equal(got[i].class_ids, d[:, 6])


def test_export_refuses_a_mesh_predictor(pair, tmp_path):
    pred = Predictor(pair["cfg"], state_dict=pair["sd"], batch_size=2,
                     mesh=_cpu_mesh(2))
    with pytest.raises(ValueError, match="single-device"):
        export_serving(pred, str(tmp_path / "m.y4t"))
    assert not (tmp_path / "m.y4t").exists()


def test_validate_on_a_mesh_predictor(pair, tmp_path):
    """The counterpart of tests/test_evaluator.py::
    test_validate_sharded_over_mesh: validate() through a 4-replica mesh
    predictor (batch 3 rounded to 4) scores what the unsharded one does."""
    root = str(tmp_path / "coco")
    make_fake_coco(root, "val2017", n_images=6, seed=3)
    cfg = _cfg(pair["cfg"])
    cfg["TEST"]["CONFTHRE"] = 0.001

    def run(pred):
        dataset = COCODataset(root, img_size=SIZE,
                              transform=Transform(cfg, keep_uint8=True))
        return validate(DataLoader(dataset, batch_size=3), pred,
                        verbose=False)

    mesh = Predictor(cfg, state_dict=pair["sd"], batch_size=3,
                     mesh=_cpu_mesh(4))
    assert mesh.batch_size == 4
    ap, ap50 = run(mesh)
    assert np.isfinite(ap) and 0.0 <= ap <= ap50 <= 1.0
    assert (ap, ap50) == run(Predictor(cfg, state_dict=pair["sd"],
                                       batch_size=4, device="cpu"))


def test_serve_cli_accepts_mesh(pair, tmp_path, monkeypatch, caplog):
    from yolov4_tpu_torch.serve import __main__ as cli
    cfg_path = tmp_path / "small.cfg"
    cfg_path.write_text(yaml.safe_dump(
        {"MODEL": {"WIDTH": 0.25, "DEPTH": 0.25, "COMPUTE_DTYPE": "float32"},
         "TEST": {"IMGSIZE": SIZE}}))
    # no card here: --mesh takes every local card, and there is none
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.build_runtime(cli.parse_args(["--cfg", str(cfg_path), "--mesh"]))
    monkeypatch.setattr(cli, "create_mesh", lambda: _cpu_mesh(2))
    rt = cli.build_runtime(cli.parse_args(["--cfg", str(cfg_path), "--mesh",
                                           "--batch-size", "3",
                                           "--sizes", "64,32"]))
    try:
        for bucket in rt.buckets.values():
            assert bucket.predictor.mesh.size == 2
            assert bucket.batch_size == bucket.predictor.batch_size == 4
            assert bucket.predictor.device.type == "cpu"
    finally:
        rt.close()
    # with --artifact, --mesh is among the flags the baked program ignores
    path = str(tmp_path / "m.y4t")
    export_serving(Predictor(pair["cfg"], state_dict=pair["sd"],
                             batch_size=2, device="cpu"), path)
    with caplog.at_level(logging.WARNING):
        art = cli.build_runtime(cli.parse_args(["--artifact", path, "--mesh",
                                                "--device", "cpu"]))
    art.close()
    assert any("--mesh" in r.getMessage() and "no effect" in r.getMessage()
               for r in caplog.records)
