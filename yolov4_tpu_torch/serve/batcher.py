"""Dynamic batcher: concurrent detect requests -> static-shape device batches.

The port's copy of the JAX package's serve/batcher.py, on the port's
Predictor. The device program has ONE static batch shape per bucket, but
production traffic arrives one image at a time. This module bridges the
two:

  * requests queue up and are packed into the Predictor's
    [batch_size, S, S, 3] shape — a batch launches when it is full or when
    the oldest request has waited ``max_wait_ms`` (latency bound);
  * short batches ride the same program (the Predictor zero-pads);
  * dispatch is ASYNC with a bounded in-flight window: the predictor's
    ``dispatch`` enqueues the batch and the copies of its outputs to
    pinned host memory behind a CUDA event, and ``fetch_local`` waits on
    that event alone, so host packing / result unmapping / the next
    batch's assembly overlap device execution, and a fetch never waits
    behind batches dispatched after it;
  * results resolve per-request futures with boxes unmapped to each
    request's ORIGINAL image coordinates.

The assembler and the fetcher are host threads: the predictor binds its
own card and ``inference_mode`` inside each call, since a new thread
starts on card 0 with autograd on. Two buckets' assemblers may launch the
kernels at once (their launch counters count under a lock).

The reference has no equivalent (its detect.py:103-122 is a synchronous
per-image python loop); this is the serving runtime a deployment wraps a
checkpoint in.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from yolov4_tpu_torch.ops.boxes import unmap_to_source_xyxy
from yolov4_tpu_torch.serve.metrics import ServeMetrics
from yolov4_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


def _safe_set(fut: Future, result=None, exc: Optional[BaseException] = None):
    """Resolve a future, tolerating a client-side cancel().

    These futures are never set_running_or_notify_cancel'd, so a client
    that times out on fut.result() CAN cancel() them — after which
    set_result/set_exception raise InvalidStateError. That must not kill
    the daemon loops (one cancelling client would wedge the whole
    bucket): a cancelled future simply has nobody left to deliver to."""
    try:
        if exc is not None:
            fut.set_exception(exc)
        else:
            fut.set_result(result)
    except Exception:  # InvalidStateError: cancelled/already resolved
        pass


@dataclass
class DetectionResult:
    """Per-request detections in SOURCE-image pixel coordinates."""
    boxes: np.ndarray        # [N, 4] float32 x1,y1,x2,y2 (source pixels)
    scores: np.ndarray       # [N] float32 = obj_conf * cls_conf
    class_ids: np.ndarray    # [N] int32 (0..79 model class indices)
    img_size: int            # model input size this request ran at
    timings_ms: Dict[str, float] = field(default_factory=dict)


@dataclass
class _Request:
    canvas: np.ndarray              # [S, S, 3] uint8 (stretch-resized RGB)
    # src_h, src_w, content_h, content_w [, off_x, off_y] (letterbox)
    img_info: Tuple[float, ...]
    future: Future
    conf_thre: Optional[float]      # post-NMS score filter (see submit())
    t_enqueue: float = 0.0
    t_assembled: float = 0.0


class DynamicBatcher:
    """Owns one Predictor (= one (size, batch) bucket) and
    two daemon threads: an assembler that groups queued requests into
    batches and dispatches them, and a fetcher that blocks on device
    results and resolves futures. ``inflight`` bounds how many dispatched
    batches may be unfetched at once (backpressure toward the queue)."""

    def __init__(self, predictor, max_wait_ms: float = 8.0,
                 inflight: int = 3, max_queue: int = 256,
                 metrics: Optional[ServeMetrics] = None,
                 name: str = ""):
        self.predictor = predictor
        self.img_size = predictor.img_size
        self.batch_size = predictor.batch_size
        self.max_wait_s = max_wait_ms / 1000.0
        self.metrics = metrics or ServeMetrics()
        self.name = name or f"bucket{self.img_size}"
        self._queue: "queue.Queue[_Request]" = queue.Queue(maxsize=max_queue)
        self._inflight: "queue.Queue" = queue.Queue(maxsize=inflight)
        self._stop = threading.Event()
        self._assembler = threading.Thread(
            target=self._assemble_loop, name=f"{self.name}-assemble",
            daemon=True)
        self._fetcher = threading.Thread(
            target=self._fetch_loop, name=f"{self.name}-fetch", daemon=True)
        self._started = False
        self._lock = threading.Lock()
        # separate from _lock: start() holds _lock across the warmup (the
        # kernels' first build), and a submit blocked on THAT lock would
        # ignore its own backpressure timeout; this one is held only for
        # instantaneous stop-check+enqueue / drain sections
        self._submit_lock = threading.Lock()
        # saturated submitters park here (releasing _submit_lock) and are
        # woken by the assembler after every queue drain — no sleep-poll
        # quantization on admission latency, no convoying on the lock
        self._space = threading.Condition(self._submit_lock)

    # -- lifecycle ---------------------------------------------------------

    def start(self, warmup: bool = True) -> "DynamicBatcher":
        with self._lock:
            if self._started:
                return self
            if warmup:
                self.predictor.warmup(dtype=np.uint8)
            self._assembler.start()
            self._fetcher.start()
            self._started = True
        return self

    def close(self, timeout: float = 10.0) -> None:
        self._stop.set()
        with self._space:
            self._space.notify_all()  # wake parked submitters to see _stop
        if self._started:
            self._assembler.join(timeout)
            self._fetcher.join(timeout)
        # fail anything stranded so callers never hang on a dead server:
        # queued requests (incl. submits that raced the _stop check — the
        # _submit_lock makes those either visible here or rejected), and
        # dispatched batches the fetcher exited before collecting (its
        # empty() check races the assembler's put)
        with self._submit_lock:
            for q in (self._queue, self._inflight):
                while True:
                    try:
                        item = q.get_nowait()
                    except queue.Empty:
                        break
                    reqs = item[0] if isinstance(item, tuple) else [item]
                    for r in reqs:
                        _safe_set(r.future,
                                  exc=RuntimeError("batcher shut down"))

    # -- request path ------------------------------------------------------

    def submit_canvas(self, canvas: np.ndarray,
                      img_info: Sequence[float],
                      conf_thre: Optional[float] = None,
                      timeout: Optional[float] = 2.0) -> Future:
        """Queue one preprocessed request. canvas: [S, S, 3] uint8 RGB
        (the val-transform stretch-resize output); img_info: (src_h, src_w,
        dst_h, dst_w) for coordinate unmapping.

        ``conf_thre`` is a POST-NMS score filter: the device program runs
        every batch at the bucket's own threshold (requests share the
        batch), so results are
        reference-exact at the bucket threshold and a stricter per-request
        threshold drops score-sorted rows host-side. Requests cannot LOWER
        the threshold below the bucket's.

        Returns a Future resolving to DetectionResult. Raises queue.Full
        after ``timeout`` when the server is saturated (backpressure)."""
        if canvas.shape != (self.img_size, self.img_size, 3):
            raise ValueError(
                f"canvas {canvas.shape} != bucket ({self.img_size}, "
                f"{self.img_size}, 3)")
        if canvas.dtype != np.uint8:
            raise ValueError(f"canvas dtype {canvas.dtype} != uint8")
        if conf_thre is not None and conf_thre < self.predictor.conf_thre:
            raise ValueError(
                f"request conf_thre {conf_thre} below bucket threshold "
                f"{self.predictor.conf_thre}")
        req = _Request(canvas=canvas, img_info=tuple(img_info),
                       future=Future(), conf_thre=conf_thre,
                       t_enqueue=time.perf_counter())
        # stop-check + enqueue under the lock close the race with close()'s
        # drain (same lock, taken after _stop is set): a request either
        # lands before the drain and gets failed there, or sees _stop and
        # is rejected — never silently stranded. When the queue is full,
        # waiting happens on a Condition over the SAME lock (released for
        # the wait), notified by the assembler after every drain — prompt
        # admission with no poll quantization and no lock convoying.
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._space:
            while True:
                if self._stop.is_set():
                    raise RuntimeError("batcher shut down")
                try:
                    self._queue.put_nowait(req)
                    break
                except queue.Full:
                    pass
                left = (None if deadline is None
                        else deadline - time.monotonic())
                if left is not None and left <= 0:
                    raise queue.Full
                # the 0.5 s cap is a defensive re-check (stop/missed
                # notify), not a poll interval — normal wakes come from
                # the assembler's notify
                self._space.wait(0.5 if left is None else min(left, 0.5))
        self.metrics.count("requests_total")
        return req.future

    # -- internals ---------------------------------------------------------

    def _queue_get(self, timeout: float) -> _Request:
        """Dequeue one request and wake a parked submitter (the queue just
        gained a slot). Raises queue.Empty like Queue.get."""
        req = self._queue.get(timeout=timeout)
        with self._space:
            self._space.notify()
        return req

    def _assemble_loop(self) -> None:
        while not self._stop.is_set():
            try:
                first = self._queue_get(timeout=0.05)
            except queue.Empty:
                continue
            batch = [first]
            deadline = time.perf_counter() + self.max_wait_s
            while len(batch) < self.batch_size and not self._stop.is_set():
                # adaptive deadline: while the in-flight window is full the
                # device pipeline is saturated — waiting for batchmates
                # costs NO latency (the dispatch would only queue behind
                # it), so keep collecting past the deadline until a slot
                # frees. A half-full batch pays the full padded upload +
                # device pass; fill matters more than eagerness under load.
                device_busy = self._inflight.full()
                remaining = deadline - time.perf_counter()
                if remaining <= 0 and not device_busy:
                    break
                try:
                    # short poll while saturated: the held batch must
                    # dispatch promptly once a slot frees (bounds the
                    # post-deadline dispatch lag to ~5 ms)
                    batch.append(self._queue_get(
                        timeout=0.005 if device_busy else max(remaining, 1e-3)))
                except queue.Empty:
                    if not device_busy:
                        break
            now = time.perf_counter()
            for r in batch:
                r.t_assembled = now
            try:
                canvases = np.stack([r.canvas for r in batch])
                out = self.predictor.dispatch(canvases)  # async on device
            except Exception as exc:  # dispatch itself failed
                logger.exception(f"{self.name}: dispatch failed")
                self.metrics.count("errors_total", len(batch))
                for r in batch:
                    _safe_set(r.future, exc=exc)
                continue
            # bounded: blocks when `inflight` batches are already on device
            placed = False
            while not self._stop.is_set():
                try:
                    self._inflight.put((batch, out, now), timeout=0.25)
                    placed = True
                    break
                except queue.Full:
                    continue
            if not placed:  # shut down mid-handoff: nobody will fetch these
                for r in batch:
                    _safe_set(r.future,
                              exc=RuntimeError("batcher shut down"))

    def _fetch_loop(self) -> None:
        while not (self._stop.is_set() and self._inflight.empty()):
            try:
                batch, out, t_dispatch = self._inflight.get(timeout=0.05)
            except queue.Empty:
                continue
            try:
                dets, valid = self.predictor.fetch_local(out)[:2]
            except Exception as exc:
                self.metrics.count("errors_total", len(batch))
                for r in batch:
                    _safe_set(r.future, exc=exc)
                continue
            t_done = time.perf_counter()
            self.metrics.count("batches_total")
            self.metrics.count("batch_rows_total", len(batch))
            self.metrics.observe("batch_ms", (t_done - t_dispatch) * 1e3)
            self.metrics.observe("batch_fill", len(batch) / self.batch_size)
            for i, req in enumerate(batch):
                try:
                    result = self._resolve(req, dets[i], valid[i], t_done)
                except Exception as exc:
                    self.metrics.count("errors_total")
                    _safe_set(req.future, exc=exc)
                else:
                    # _safe_set: a client that timed out and cancel()ed
                    # must not kill this loop (the old set_exception-on-
                    # InvalidStateError re-raise wedged the whole bucket)
                    _safe_set(req.future, result=result)

    def _resolve(self, req: _Request, det: np.ndarray, valid: np.ndarray,
                 t_done: float) -> DetectionResult:
        d = det[valid]
        scores = d[:, 4] * d[:, 5]
        if req.conf_thre is not None:
            keep = scores >= req.conf_thre
            d, scores = d[keep], scores[keep]
        src_h, src_w, dst_h, dst_w = req.img_info[:4]
        off = (tuple(req.img_info[4:6]) if len(req.img_info) >= 6
               else (0.0, 0.0))  # letterbox offsets (TEST.LETTERBOX)
        boxes = (np.asarray(unmap_to_source_xyxy(
                     d[:, :4], (src_h, src_w), (dst_h, dst_w),
                     offset_xy=off), np.float32)
                 if d.shape[0] else np.zeros((0, 4), np.float32))
        e2e_ms = (t_done - req.t_enqueue) * 1e3
        queue_ms = (req.t_assembled - req.t_enqueue) * 1e3
        self.metrics.observe("e2e_ms", e2e_ms)
        self.metrics.observe("queue_ms", queue_ms)
        self.metrics.count("detections_total", int(d.shape[0]))
        return DetectionResult(
            boxes=boxes, scores=scores.astype(np.float32),
            class_ids=d[:, 6].astype(np.int32), img_size=self.img_size,
            timings_ms={"e2e": e2e_ms, "queue": queue_ms})

    def stats(self) -> Dict[str, float]:
        return {"queue_depth": self._queue.qsize(),
                "inflight_batches": self._inflight.qsize()}
