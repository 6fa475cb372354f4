"""HTTP detection server: multi-bucket serving runtime + stdlib HTTP front.

The port's copy of the JAX package's serve/server.py. One
``ServingRuntime`` holds a DynamicBatcher per configured image size
(static-shape buckets share one model and its weights on the card); the
HTTP layer is a
``ThreadingHTTPServer`` whose handler threads do the cv2 decode +
stretch-resize (CPU work parallelizes across request threads) and block on
the batcher future.

Endpoints:
  POST /v1/detect[?size=608][&conf=0.25]   body: jpeg/png bytes
      -> {"detections": [{"box": [x1,y1,x2,y2], "score": s,
           "class_id": c, "class_name": "..."}], "img_size": n,
          "timings_ms": {...}}
  POST /v1/detect_raw?h=H&w=W[&size=][&conf=]   body: raw uint8 BGR HWC
      bytes (H*W*3) — skips the jpeg decode, for clients that already
      hold decoded frames (video pipelines, upstream decode farms) and
      for benchmarking the runtime without the host-CPU decode bound;
      response schema identical to /v1/detect
  GET  /healthz     -> 200 {"status": "ok"} once warm
  GET  /v1/config   -> bucket/threshold configuration
  GET  /metrics     -> Prometheus text exposition
  GET  /stats       -> JSON metrics snapshot

The reference has no serving runtime (deployment = detect.py per-image CLI,
detect.py:103-122); this subsystem is capability the JAX package added.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Sequence
from urllib.parse import parse_qs, urlparse

import numpy as np

from yolov4_tpu_torch.data.transforms import Transform
from yolov4_tpu_torch.engine.predictor import Predictor
from yolov4_tpu_torch.serve.batcher import DetectionResult, DynamicBatcher
from yolov4_tpu_torch.serve.metrics import ServeMetrics
from yolov4_tpu_torch.utils.logging import get_logger
from yolov4_tpu_torch.utils.visualize import class_name

logger = get_logger(__name__)


class ServingRuntime:
    """Buckets keyed by model input size, all sharing one model.

    ``sizes[0]`` is the default bucket. Each size is its own Predictor
    (one static batch shape each) over the same ``nn.Module``: the
    weights are loaded onto the card once and read by every bucket.
    ``state_dict``: the weights (None: the seed-0 reference init);
    ``device``: None means CUDA."""

    def __init__(self, cfg: Dict, state_dict=None,
                 sizes: Optional[Sequence[int]] = None,
                 batch_size: int = 16, max_wait_ms: float = 8.0,
                 inflight: int = 3, conf_thre: Optional[float] = None,
                 nms_thre: Optional[float] = None,
                 request_timeout_s: float = 120.0,
                 predictors: Optional[Dict[int, object]] = None,
                 device=None):
        self.cfg = cfg
        # generous default: the first dispatch of a bucket builds the
        # kernels and lets cuDNN pick its algorithms
        self.request_timeout_s = request_timeout_s
        self.metrics = ServeMetrics()
        self._transform = Transform(cfg, is_train=False, keep_uint8=True)
        self.buckets: Dict[int, DynamicBatcher] = {}
        if predictors is not None:
            # prebuilt predictor-likes (e.g. ArtifactPredictor buckets)
            self.sizes = [int(s) for s in predictors]
            for size, pred in predictors.items():
                self.buckets[int(size)] = DynamicBatcher(
                    pred, max_wait_ms=max_wait_ms, inflight=inflight,
                    metrics=self.metrics, name=f"bucket{size}")
        else:
            self.sizes = [int(s) for s in (sizes or [cfg["TEST"]["IMGSIZE"]])]
            model = None
            for size in self.sizes:
                # the first Predictor builds and loads the model; the
                # others run the same module
                pred = Predictor(cfg, state_dict=state_dict, img_size=size,
                                 batch_size=batch_size, conf_thre=conf_thre,
                                 nms_thre=nms_thre, device=device,
                                 model=model)
                model, state_dict = pred.model, None
                self.buckets[size] = DynamicBatcher(
                    pred, max_wait_ms=max_wait_ms, inflight=inflight,
                    metrics=self.metrics, name=f"bucket{size}")
        self.ready = False

    @classmethod
    def from_artifacts(cls, paths: Sequence[str], max_wait_ms: float = 8.0,
                       inflight: int = 3,
                       request_timeout_s: float = 120.0,
                       device=None) -> "ServingRuntime":
        """Serve straight from exported single-file artifacts (one bucket
        per file, keyed by the artifact's img_size; thresholds are the
        baked export-time values). The serving host needs torch, this
        package's ops and the files only."""
        from yolov4_tpu_torch.config import load_config
        from yolov4_tpu_torch.serve.artifact import ArtifactPredictor

        preds = {}
        for p in paths:
            ap = ArtifactPredictor.load(p, device=device)
            if ap.img_size in preds:
                raise ValueError(f"duplicate bucket size {ap.img_size} "
                                 f"from {p}")
            if ap._wire_dtype != np.uint8:
                # the HTTP path submits uint8 canvases; a float32-wire
                # artifact would pass warmup then fail every request
                raise ValueError(
                    f"{p}: artifact wire dtype {ap._wire_dtype} is not "
                    f"servable over HTTP (re-export with uint8 wire)")
            preds[ap.img_size] = ap
        # preprocessing (BGR->RGB + stretch resize) needs no model config;
        # the default config supplies the transform's unused-on-val knobs
        cfg = load_config(None)
        cfg["MODEL"]["QUANT"] = next(iter(preds.values())).quant
        return cls(cfg, predictors=preds, max_wait_ms=max_wait_ms,
                   inflight=inflight, request_timeout_s=request_timeout_s)

    def start(self, warmup: bool = True) -> "ServingRuntime":
        for b in self.buckets.values():
            b.start(warmup=warmup)
        self.ready = True
        return self

    def close(self) -> None:
        self.ready = False
        for b in self.buckets.values():
            b.close()

    def preprocess(self, img_bgr: np.ndarray, size: int):
        """Reference val preprocessing (BGR->RGB + stretch-resize, or
        letterbox when cfg TEST.LETTERBOX; the deterministic transform is
        thread-safe). Returns the 6-field geometry img_info (offsets 0
        for stretch) so the batcher unmaps letterboxed boxes correctly."""
        canvas, target = self._transform([img_bgr], [np.zeros((0, 5))], size)
        return canvas, target["img_info"][:6]

    def detect(self, img_bgr: np.ndarray, size: Optional[int] = None,
               conf_thre: Optional[float] = None,
               timeout: Optional[float] = None) -> DetectionResult:
        """Synchronous detect on a decoded BGR image (HTTP handler path)."""
        timeout = self.request_timeout_s if timeout is None else timeout
        size = int(size or self.sizes[0])
        if size not in self.buckets:
            raise KeyError(f"no bucket for size {size} "
                           f"(configured: {self.sizes})")
        canvas, img_info = self.preprocess(img_bgr, size)
        fut = self.buckets[size].submit_canvas(canvas, img_info,
                                               conf_thre=conf_thre)
        return fut.result(timeout=timeout)

    def stats(self) -> Dict:
        snap = self.metrics.snapshot()
        snap["buckets"] = {str(s): b.stats() for s, b in self.buckets.items()}
        snap["ready"] = self.ready
        return snap

    def gauges(self) -> Dict[str, float]:
        out = {"ready": float(self.ready)}
        for s, b in self.buckets.items():
            for k, v in b.stats().items():
                out[f"{k}{{size_{s}}}".replace("{", "_").replace("}", "")] = v
        return out


def result_to_json(res: DetectionResult) -> Dict:
    return {
        "img_size": res.img_size,
        "num_detections": int(res.boxes.shape[0]),
        "detections": [{
            "box": [round(float(v), 2) for v in res.boxes[i]],
            "score": round(float(res.scores[i]), 5),
            "class_id": int(res.class_ids[i]),
            "class_name": class_name(int(res.class_ids[i])),
        } for i in range(res.boxes.shape[0])],
        "timings_ms": {k: round(v, 2) for k, v in res.timings_ms.items()},
    }


class _Handler(BaseHTTPRequestHandler):
    # class attr set by make_server
    runtime: ServingRuntime = None
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # route through framework logging
        logger.debug("http: " + fmt % args)

    def _send(self, code: int, payload, content_type="application/json"):
        body = (payload if isinstance(payload, bytes)
                else json.dumps(payload).encode())
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        path = urlparse(self.path).path
        rt = self.runtime
        if path == "/healthz":
            code = 200 if rt.ready else 503
            self._send(code, {"status": "ok" if rt.ready else "warming"})
        elif path == "/metrics":
            self._send(200, rt.metrics.render_prometheus(rt.gauges()).encode(),
                       content_type="text/plain; version=0.0.4")
        elif path == "/stats":
            self._send(200, rt.stats())
        elif path == "/v1/config":
            self._send(200, {
                "sizes": rt.sizes,
                "batch_size": {str(s): b.batch_size
                               for s, b in rt.buckets.items()},
                "conf_thre": {str(s): b.predictor.conf_thre
                              for s, b in rt.buckets.items()},
                "nms_thre": {str(s): b.predictor.nms_thre
                             for s, b in rt.buckets.items()},
                "quant": rt.cfg["MODEL"].get("QUANT", "none"),
            })
        else:
            self._send(404, {"error": f"unknown path {path}"})

    max_body_bytes = 64 * 1024 * 1024  # reject absurd uploads pre-read

    def do_POST(self):
        import cv2
        url = urlparse(self.path)
        if url.path not in ("/v1/detect", "/v1/detect_raw"):
            self._send(404, {"error": f"unknown path {url.path}"})
            return
        rt = self.runtime
        if not rt.ready:
            self._send(503, {"error": "server warming up"})
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
            if length <= 0:
                raise ValueError("empty body (send jpeg/png bytes)")
            if length > self.max_body_bytes:
                # body is NOT drained: close the connection so remaining
                # bytes can't desync a keep-alive stream into garbage
                # requests
                self.close_connection = True
                rt.metrics.count("errors_total")
                self._send(413, {"error": f"body {length} bytes exceeds "
                                          f"{self.max_body_bytes}"})
                return
            raw = self.rfile.read(length)
            q = parse_qs(url.query)
            if url.path == "/v1/detect_raw":
                # pre-decoded frames: raw uint8 BGR HWC bytes, shape in
                # the query (?h=&w=) — no jpeg decode on the server CPU
                if "h" not in q or "w" not in q:
                    raise ValueError(
                        "detect_raw needs ?h=&w= (raw uint8 BGR HWC body)")
                h, w = int(q["h"][0]), int(q["w"][0])
                if h <= 0 or w <= 0 or length != h * w * 3:
                    raise ValueError(
                        f"body {length} bytes != h*w*3 = {h * w * 3} "
                        f"(h={h}, w={w})")
                img = np.frombuffer(raw, np.uint8).reshape(h, w, 3)
            else:
                img = cv2.imdecode(np.frombuffer(raw, np.uint8),
                                   cv2.IMREAD_COLOR)
                if img is None:
                    raise ValueError("body is not a decodable image")
            size = int(q["size"][0]) if "size" in q else None
            conf = float(q["conf"][0]) if "conf" in q else None
            res = rt.detect(img, size=size, conf_thre=conf)
            self._send(200, result_to_json(res))
        except (ValueError, KeyError) as exc:
            rt.metrics.count("errors_total")
            self._send(400, {"error": str(exc)})
        except Exception as exc:  # noqa: BLE001 — server must not die
            logger.exception("detect request failed")
            rt.metrics.count("errors_total")
            self._send(500, {"error": f"{type(exc).__name__}: {exc}"})


class _Server(ThreadingHTTPServer):
    daemon_threads = True
    # the stdlib default listen backlog (5) drops connections under a
    # burst of concurrent clients — raise it to serving-appropriate depth
    request_queue_size = 128


def make_server(runtime: ServingRuntime, host: str = "127.0.0.1",
                port: int = 0) -> ThreadingHTTPServer:
    """Build (not start) the HTTP server; ``port=0`` binds an ephemeral
    port (tests). Call .serve_forever() or serve_background()."""
    handler = type("BoundHandler", (_Handler,), {"runtime": runtime})
    return _Server((host, port), handler)


def serve_background(srv: ThreadingHTTPServer) -> threading.Thread:
    t = threading.Thread(target=srv.serve_forever, name="http-serve",
                         daemon=True)
    t.start()
    return t
