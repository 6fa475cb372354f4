"""The port's serving runtime (yolov4_tpu_torch/serve/) on the CPU: the cases
of tests/test_serve.py that need no int8 and no mesh, with the port's
batcher and runtime, plus the port against the JAX package's batcher on the
same converted weights and canvases, buckets sharing one model, a threaded
stress run, and the ``python -m yolov4_tpu_torch.serve`` CLI.

The batcher must (a) group concurrent requests into the static batch, (b)
flush partial batches at the latency deadline, (c) return per-request
results identical to direct Predictor calls with the same batch
composition, and (d) never hang callers across shutdown. Every wait here
has a timeout."""

import json
import os
import queue as queue_mod
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import cv2
import numpy as np
import pytest
import torch
import yaml

from tests.test_torch_helpers import small_model_pair
from yolov4_tpu.engine.predictor import Predictor as JaxPredictor
from yolov4_tpu.serve import DynamicBatcher as JaxDynamicBatcher
from yolov4_tpu_torch.config import Config
from yolov4_tpu_torch.engine.predictor import Predictor
from yolov4_tpu_torch.serve import (DynamicBatcher, ServingRuntime,
                                    make_server, result_to_json,
                                    serve_background)

torch.set_num_threads(1)

SIZE = 64
SMALL = {"MODEL": {"WIDTH": 0.25, "DEPTH": 0.25, "COMPUTE_DTYPE": "float32"},
         "TEST": {"IMGSIZE": SIZE, "PRE_NMS_TOPK": 64, "MAX_DETS": 10,
                  "CONFTHRE": 0.01}}
INFO = (SIZE, SIZE, SIZE, SIZE)  # identity unmap
TIMEOUT = 120


def _small_cfg(**model_over):
    raw = {k: dict(v) for k, v in SMALL.items()}
    raw["MODEL"].update(model_over)
    return Config.from_dict(raw)


class FakePredictor:
    """Predictor stand-in: records dispatched batch sizes; each request's
    single detection row carries its canvas's first byte so results can be
    matched back to requests."""

    def __init__(self, img_size=SIZE, batch_size=4, conf_thre=0.1,
                 nms_thre=0.5, delay_s=0.0):
        self.img_size = img_size
        self.batch_size = batch_size
        self.conf_thre = conf_thre
        self.nms_thre = nms_thre
        self.batch_sizes = []
        self.delay_s = delay_s

    def warmup(self, dtype=None):
        pass

    def dispatch(self, images):
        self.batch_sizes.append(images.shape[0])
        if self.delay_s:
            time.sleep(self.delay_s)
        n = images.shape[0]
        det = np.zeros((n, 1, 7), np.float32)
        det[:, 0, :4] = [1.0, 2.0, 3.0, 4.0]
        det[:, 0, 4] = images[:, 0, 0, 0].astype(np.float32) / 255.0  # obj
        det[:, 0, 5] = 1.0                                    # cls_conf
        det[:, 0, 6] = 7.0                                    # class
        return det, np.ones((n, 1), bool)

    @staticmethod
    def fetch_local(out):
        return out


def _canvas(value):
    return np.full((SIZE, SIZE, 3), value, np.uint8)


def test_batcher_groups_requests_and_flushes_tail():
    fake = FakePredictor(batch_size=4)
    b = DynamicBatcher(fake, max_wait_ms=300.0).start()
    try:
        futs = [b.submit_canvas(_canvas(10 + i), INFO) for i in range(6)]
        results = [f.result(timeout=10) for f in futs]
    finally:
        b.close()
    # 6 fast submissions into batch_size 4: one full batch + deadline tail
    assert fake.batch_sizes == [4, 2]
    for i, r in enumerate(results):
        assert r.scores.shape == (1,)
        np.testing.assert_allclose(r.scores[0], (10 + i) / 255.0, rtol=1e-6)
        np.testing.assert_allclose(r.boxes[0], [1, 2, 3, 4], rtol=1e-6)
        assert r.class_ids[0] == 7
    snap = b.metrics.snapshot()
    assert snap["counters"]["requests_total"] == 6
    assert snap["counters"]["batches_total"] == 2
    assert snap["counters"]["batch_rows_total"] == 6
    assert snap["counters"]["errors_total"] == 0


def test_single_request_flushes_at_deadline():
    fake = FakePredictor(batch_size=8)
    b = DynamicBatcher(fake, max_wait_ms=50.0).start()
    try:
        t0 = time.perf_counter()
        res = b.submit_canvas(_canvas(99), INFO).result(timeout=10)
        dt = time.perf_counter() - t0
    finally:
        b.close()
    assert fake.batch_sizes == [1]
    assert res.scores.shape == (1,)
    assert dt < 30.0
    assert res.timings_ms["e2e"] >= 0.0


def test_per_request_conf_is_post_nms_filter():
    fake = FakePredictor(batch_size=2, conf_thre=0.1)
    b = DynamicBatcher(fake, max_wait_ms=20.0).start()
    try:
        # obj = 128/255 = 0.502; request conf above that drops the row
        lo = b.submit_canvas(_canvas(128), INFO, conf_thre=0.3)
        hi = b.submit_canvas(_canvas(128), INFO, conf_thre=0.9)
        assert lo.result(10).scores.shape == (1,)
        assert hi.result(10).scores.shape == (0,)
        assert hi.result(10).boxes.shape == (0, 4)
        with pytest.raises(ValueError, match="below bucket"):
            b.submit_canvas(_canvas(1), INFO, conf_thre=0.01)
    finally:
        b.close()


def test_shape_and_dtype_validation():
    b = DynamicBatcher(FakePredictor(batch_size=2), max_wait_ms=10.0)
    with pytest.raises(ValueError, match="canvas"):
        b.submit_canvas(np.zeros((SIZE, SIZE + 1, 3), np.uint8), INFO)
    with pytest.raises(ValueError, match="uint8"):
        b.submit_canvas(np.zeros((SIZE, SIZE, 3), np.float32), INFO)
    b.close()


def test_close_fails_pending_and_rejects_new():
    b = DynamicBatcher(FakePredictor(batch_size=2), max_wait_ms=10.0)
    fut = b.submit_canvas(_canvas(1), INFO)  # never started -> stays queued
    b.close()
    with pytest.raises(RuntimeError, match="shut down"):
        fut.result(timeout=1)
    with pytest.raises(RuntimeError, match="shut down"):
        b.submit_canvas(_canvas(1), INFO)


def test_submit_backpressure_timeout_and_close_wake():
    fake = FakePredictor(batch_size=4)
    b = DynamicBatcher(fake, max_queue=1)  # NOT started: nothing drains
    b.submit_canvas(_canvas(1), INFO)      # fills the queue
    t0 = time.monotonic()
    with pytest.raises(queue_mod.Full):
        b.submit_canvas(_canvas(2), INFO, timeout=0.2)
    assert time.monotonic() - t0 < 5.0
    woke = []

    def park():
        try:
            b.submit_canvas(_canvas(3), INFO, timeout=30.0)
        except RuntimeError as e:
            woke.append(str(e))

    th = threading.Thread(target=park)
    th.start()
    time.sleep(0.15)  # let it park
    b.close()
    th.join(5.0)
    assert not th.is_alive()
    assert woke and "shut down" in woke[0]


def test_submit_waiter_admitted_when_queue_drains():
    fake = FakePredictor(batch_size=4)
    b = DynamicBatcher(fake, max_queue=1)  # NOT started: manual drain
    b.submit_canvas(_canvas(1), INFO)
    admitted = threading.Event()

    def park():
        b.submit_canvas(_canvas(2), INFO, timeout=30.0)
        admitted.set()

    th = threading.Thread(target=park)
    th.start()
    time.sleep(0.15)
    assert not admitted.is_set()
    b._queue_get(timeout=1.0)  # assembler-side drain frees one slot
    assert admitted.wait(5.0)
    th.join(5.0)
    assert not th.is_alive()
    b.close()


def test_cancelled_future_does_not_kill_fetcher():
    fake = FakePredictor(batch_size=2, delay_s=0.1)
    b = DynamicBatcher(fake, max_wait_ms=5.0).start()
    try:
        doomed = b.submit_canvas(_canvas(1), INFO)
        assert doomed.cancel()
        for v in (20, 30, 40):
            r = b.submit_canvas(_canvas(v), INFO).result(timeout=10)
            np.testing.assert_allclose(r.scores[0], v / 255.0, rtol=1e-6)
    finally:
        b.close()


def test_close_drains_stranded_inflight_batch():
    from concurrent.futures import Future

    from yolov4_tpu_torch.serve.batcher import _Request

    b = DynamicBatcher(FakePredictor(batch_size=2), max_wait_ms=10.0)
    b.start()
    b._stop.set()  # fetcher drains and exits
    time.sleep(0.3)
    stranded = _Request(canvas=_canvas(5), img_info=INFO, future=Future(),
                        conf_thre=None)
    b._inflight.put(([stranded], None, 0.0))  # the raced post-exit put
    b.close()
    with pytest.raises(RuntimeError, match="shut down"):
        stranded.future.result(timeout=1)


def test_dispatch_error_propagates_to_futures():
    class Boom(FakePredictor):
        def dispatch(self, images):
            raise RuntimeError("device fell over")

    b = DynamicBatcher(Boom(batch_size=2), max_wait_ms=10.0).start()
    try:
        fut = b.submit_canvas(_canvas(1), INFO)
        with pytest.raises(RuntimeError, match="fell over"):
            fut.result(timeout=10)
        assert b.metrics.snapshot()["counters"]["errors_total"] == 1
    finally:
        b.close()


# ---------------------------------------------------------------------------
# the port's Predictor behind the batcher, against the JAX package's
# ---------------------------------------------------------------------------

SLICE_TEST = {"PRE_NMS_TOPK": 64, "MAX_DETS": 50, "CONFTHRE": 0.05,
              "NMSTHRE": 0.45}


@pytest.fixture(scope="module")
def pair():
    """The port's and the JAX package's predictors on the same weights
    (tests/test_torch_predictor.py's seed 9 / head_scale 0.5, whose score
    orders are separated beyond the two forwards' difference)."""
    jcfg, cfg, _, jvars, sd = small_model_pair(seed=9, head_scale=0.5)
    for c in (jcfg, cfg):
        c["TEST"].update(SLICE_TEST)
    return dict(
        port=Predictor(cfg, state_dict=sd, img_size=SIZE, batch_size=4,
                       device="cpu"),
        jax=JaxPredictor(jcfg, variables=jvars, img_size=SIZE, batch_size=4),
        cfg=cfg, sd=sd)


def _through(batcher_cls, predictor, imgs, info=INFO):
    b = batcher_cls(predictor, max_wait_ms=500.0)
    b.start(warmup=False)
    try:
        futs = [b.submit_canvas(img, info) for img in imgs]
        return [f.result(timeout=TIMEOUT) for f in futs]
    finally:
        b.close()


def test_batcher_matches_direct_predictor(pair):
    """Same batch composition through the batcher and the direct call must
    produce identical detections (the batcher adds routing, not math)."""
    pred = pair["port"]
    imgs = np.random.default_rng(0).integers(0, 256, (4, SIZE, SIZE, 3),
                                             np.uint8)
    got = _through(DynamicBatcher, pred, imgs)
    dets, valids = pred(imgs)
    for i in range(4):
        d = dets[i][valids[i]]
        np.testing.assert_array_equal(got[i].boxes, d[:, :4])
        np.testing.assert_array_equal(got[i].scores, d[:, 4] * d[:, 5])
        np.testing.assert_array_equal(got[i].class_ids,
                                      d[:, 6].astype(np.int32))


def test_batcher_matches_jax_batcher(pair):
    """The port's batcher on the port's Predictor against the JAX
    package's batcher on its Predictor, same weights and canvases, with
    a source size to unmap to: the same rows, within
    tests/test_torch_predictor.py's tolerance."""
    imgs = np.random.default_rng(4).integers(0, 256, (4, SIZE, SIZE, 3),
                                             np.uint8)
    info = (97, 130, SIZE, SIZE)
    got = _through(DynamicBatcher, pair["port"], imgs, info)
    want = _through(JaxDynamicBatcher, pair["jax"], imgs, info)
    assert sum(r.scores.shape[0] for r in got) > 4
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.class_ids, w.class_ids)
        np.testing.assert_allclose(g.boxes, w.boxes, rtol=1e-4, atol=3e-3)
        np.testing.assert_allclose(g.scores, w.scores, atol=1e-5)
        assert g.img_size == w.img_size


def test_concurrent_submitters_stress(pair):
    """More submitting threads than cores, a short switch interval: every
    thread gets exactly its own result (a lost update or a swapped row
    would show as a mismatch against the direct call)."""
    pred = pair["port"]
    b = DynamicBatcher(pred, max_wait_ms=5.0)
    b.start(warmup=False)
    results, errors = {}, []
    imgs = np.random.default_rng(11).integers(0, 256, (16, SIZE, SIZE, 3),
                                              np.uint8)

    def worker(idx):
        try:
            results[idx] = b.submit_canvas(imgs[idx], INFO).result(TIMEOUT)
        except Exception as exc:  # noqa: BLE001
            errors.append((idx, exc))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    threads = [threading.Thread(target=worker, args=(i,)) for i in range(16)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT)
    finally:
        sys.setswitchinterval(old)
        b.close()
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert len(results) == 16
    for idx in range(16):
        dets, valids = pred(imgs[idx][None])
        d = dets[0][valids[0]]
        np.testing.assert_array_equal(results[idx].boxes, d[:, :4])
        np.testing.assert_array_equal(results[idx].class_ids,
                                      d[:, 6].astype(np.int32))
    snap = b.metrics.snapshot()
    assert snap["counters"]["batch_rows_total"] == 16
    assert snap["counters"]["errors_total"] == 0


def test_buckets_share_one_model(pair):
    rt = ServingRuntime(pair["cfg"], state_dict=pair["sd"], sizes=[SIZE, 32],
                        batch_size=2, device="cpu")
    try:
        a, b = (rt.buckets[s].predictor for s in (SIZE, 32))
        assert a.model is b.model
        loaded = a.model.state_dict()
        for key, value in pair["sd"].items():
            assert torch.equal(loaded[key], value), key
        assert (a.img_size, b.img_size) == (SIZE, 32)
    finally:
        rt.close()


# ---------------------------------------------------------------------------
# HTTP layer
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def http_runtime():
    rt = ServingRuntime(_small_cfg(PALLAS_CSP=True), sizes=[SIZE, 32],
                        batch_size=2, max_wait_ms=5.0, conf_thre=0.01,
                        device="cpu")
    rt.start(warmup=False)
    srv = make_server(rt, port=0)
    thread = serve_background(srv)
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    yield rt, base
    srv.shutdown()
    thread.join(10)
    rt.close()


def _get(url):
    with urllib.request.urlopen(url, timeout=TIMEOUT) as r:
        return r.status, r.read()


def _post(url, data):
    req = urllib.request.Request(url, data=data, method="POST")
    with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
        assert r.status == 200
        return json.loads(r.read())


def test_http_detect_roundtrip(http_runtime):
    rt, base = http_runtime
    img = np.random.default_rng(3).integers(0, 256, (97, 130, 3), np.uint8)
    ok, jpeg = cv2.imencode(".jpg", img)
    assert ok
    body = _post(f"{base}/v1/detect", jpeg.tobytes())
    assert body["img_size"] == SIZE
    assert body["num_detections"] == len(body["detections"]) > 0
    for det in body["detections"]:
        assert len(det["box"]) == 4
        assert 0.0 <= det["score"] <= 1.0
        assert isinstance(det["class_name"], str)
    # the non-default bucket serves too
    assert _post(f"{base}/v1/detect?size=32",
                 jpeg.tobytes())["img_size"] == 32


def test_http_detect_raw_matches_direct(http_runtime):
    """/v1/detect_raw returns exactly what the runtime computes for the
    same pixels, and that is the direct predictor's rows unmapped."""
    rt, base = http_runtime
    img = np.random.default_rng(9).integers(0, 256, (41, 53, 3), np.uint8)
    body = _post(f"{base}/v1/detect_raw?h=41&w=53&conf=0.02",
                 img.tobytes())
    res = rt.detect(img, conf_thre=0.02)
    direct = result_to_json(res)
    for k in ("img_size", "num_detections", "detections"):
        assert body[k] == direct[k], k
    pred = rt.buckets[SIZE].predictor
    canvas, info = rt.preprocess(img, SIZE)
    dets, valids = pred(canvas[None])
    d = dets[0][valids[0]]
    d = d[d[:, 4] * d[:, 5] >= 0.02]
    from yolov4_tpu_torch.ops.boxes import unmap_to_source_xyxy
    want = np.asarray(unmap_to_source_xyxy(d[:, :4], info[:2], info[2:4],
                                           info[4:6]), np.float32)
    np.testing.assert_array_equal(res.boxes, want)


def test_http_detect_raw_error_paths(http_runtime):
    rt, base = http_runtime
    img = np.zeros((8, 8, 3), np.uint8)
    for url in (f"{base}/v1/detect_raw", f"{base}/v1/detect_raw?h=9&w=9"):
        req = urllib.request.Request(url, data=img.tobytes(), method="POST")
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=60)
        assert ei.value.code == 400


def test_http_health_config_metrics(http_runtime):
    rt, base = http_runtime
    status, body = _get(f"{base}/healthz")
    assert status == 200 and json.loads(body)["status"] == "ok"
    cfg = json.loads(_get(f"{base}/v1/config")[1])
    assert cfg["sizes"] == [SIZE, 32]
    assert cfg["batch_size"][str(SIZE)] == 2
    assert cfg["quant"] == "none"
    text = _get(f"{base}/metrics")[1].decode()
    assert "yolov4_serve_requests_total" in text
    assert "yolov4_serve_e2e_ms" in text
    assert "yolov4_serve_ready 1" in text
    stats = json.loads(_get(f"{base}/stats")[1])
    assert stats["ready"] is True
    assert str(SIZE) in stats["buckets"]


def test_http_error_paths(http_runtime):
    rt, base = http_runtime
    req = urllib.request.Request(f"{base}/v1/detect", data=b"not an image",
                                 method="POST")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=60)
    assert e.value.code == 400
    ok, jpeg = cv2.imencode(".jpg", np.zeros((8, 8, 3), np.uint8))
    req = urllib.request.Request(f"{base}/v1/detect?size=999",
                                 data=jpeg.tobytes(), method="POST")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=60)
    assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(f"{base}/nope")
    assert e.value.code == 404
    assert _get(f"{base}/healthz")[0] == 200


def test_http_oversize_body_rejected(http_runtime):
    rt, base = http_runtime
    import socket
    host, port = base.replace("http://", "").split(":")
    with socket.create_connection((host, int(port)), timeout=60) as s:
        s.sendall(b"POST /v1/detect HTTP/1.1\r\n"
                  b"Host: x\r\n"
                  b"Content-Length: 209715200\r\n\r\n")
        status_line = s.makefile("rb").readline()
    assert b"413" in status_line, status_line
    assert _get(f"{base}/healthz")[0] == 200


def test_artifact_serving_matches_live(pair, tmp_path):
    """ServingRuntime.from_artifacts drives the exported program through
    the batcher with results identical to the live Predictor's."""
    from yolov4_tpu_torch.utils.export import export_serving
    pred = pair["port"]
    path = str(tmp_path / "m.y4t")
    export_serving(pred, path)
    rt = ServingRuntime.from_artifacts([path], max_wait_ms=300.0,
                                       device="cpu")
    rt.start(warmup=False)
    try:
        assert rt.sizes == [SIZE]
        bucket = rt.buckets[SIZE]
        assert bucket.batch_size == pred.batch_size
        assert bucket.predictor.conf_thre == pred.conf_thre
        imgs = np.random.default_rng(5).integers(0, 256, (4, SIZE, SIZE, 3),
                                                 np.uint8)
        futs = [bucket.submit_canvas(imgs[i], INFO) for i in range(4)]
        got = [f.result(timeout=TIMEOUT) for f in futs]
    finally:
        rt.close()
    dets, valids = pred(imgs)
    for i in range(4):
        d = dets[i][valids[i]]
        np.testing.assert_array_equal(got[i].boxes, d[:, :4])
        np.testing.assert_array_equal(
            got[i].scores, (d[:, 4] * d[:, 5]).astype(np.float32))
    with pytest.raises(ValueError, match="duplicate"):
        ServingRuntime.from_artifacts([path, path], device="cpu")


# ---------------------------------------------------------------------------
# python -m yolov4_tpu_torch.serve
# ---------------------------------------------------------------------------


def test_cli_refuses_mesh_and_int8_and_warns_on_artifact_flags(tmp_path,
                                                               caplog):
    from yolov4_tpu_torch.serve import __main__ as cli
    with pytest.raises(SystemExit, match="multi-card serving is not ported"):
        cli.build_runtime(cli.parse_args(["--mesh", "--device", "cpu"]))
    cfg_path = tmp_path / "small.cfg"
    cfg_path.write_text(yaml.safe_dump(SMALL))
    with pytest.raises(ValueError, match="QUANT"):
        cli.build_runtime(cli.parse_args(["--cfg", str(cfg_path), "--quant",
                                          "int8", "--device", "cpu"]))
    rt = cli.build_runtime(cli.parse_args(["--cfg", str(cfg_path),
                                           "--sizes", "64,32",
                                           "--conf-thre", "-1",
                                           "--device", "cpu"]))
    assert rt.sizes == [64, 32]
    pred = rt.buckets[64].predictor
    # a negative --conf-thre and the default --nms-thre take the cfg's
    assert (pred.conf_thre, pred.nms_thre) == (
        0.01, _small_cfg()["TEST"]["NMSTHRE"])
    assert pred.device.type == "cpu" and pred.batch_size == 16
    rt.close()


def test_cli_serves_over_http_and_stops_on_sigterm(tmp_path):
    """The CLI on the CPU with a small cfg: it logs its address, answers
    /healthz and /v1/detect, and a SIGTERM closes it with exit code 0."""
    cfg_path = tmp_path / "small.cfg"
    cfg_path.write_text(yaml.safe_dump(SMALL))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "yolov4_tpu_torch.serve", "--cfg",
         str(cfg_path), "--device", "cpu", "--port", "0", "--batch-size",
         "2"], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env)
    lines = []
    try:
        deadline = time.time() + TIMEOUT
        base = None
        while base is None and time.time() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            lines.append(line)
            if "serving on http://" in line:
                base = line.split("serving on ")[1].split(" ")[0]
        assert base, "".join(lines)
        assert _get(f"{base}/healthz")[0] == 200
        ok, jpeg = cv2.imencode(".jpg", np.full((50, 70, 3), 90, np.uint8))
        assert _post(f"{base}/v1/detect", jpeg.tobytes())["img_size"] == SIZE
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.stdout.close()
