"""Serve from an exported single-file artifact (utils/export.py).

``ArtifactPredictor`` adapts a loaded ServingArtifact to the predictor
interface the DynamicBatcher drives (img_size, batch_size, conf_thre,
warmup, dispatch, fetch_local), so the HTTP server can run off ONE file —
no model code, config or checkpoint on the serving host. Thresholds are
the ones baked at export time. It uploads NHWC canvases and lays them out
as the artifact's planar wire on the device; it fetches through pinned
memory behind an event, as the live Predictor does (engine/predictor.py).
"""

from __future__ import annotations

import numpy as np

from yolov4_tpu_torch.engine.predictor import (device_scope, fetch_local,
                                               nhwc_to_wire, start_fetch,
                                               upload_nhwc)
from yolov4_tpu_torch.utils.export import ServingArtifact, load_serving


class ArtifactPredictor:
    def __init__(self, artifact: ServingArtifact):
        self.artifact = artifact
        self.device = artifact.device
        meta = artifact.meta
        self.img_size = int(meta["img_size"])
        self.batch_size = int(meta["batch_size"])
        self.conf_thre = float(meta["conf_thre"])
        self.nms_thre = float(meta["nms_thre"])
        self.num_classes = int(meta["num_classes"])
        self.max_dets = int(meta["max_dets"])
        self.quant = meta.get("quant", "none")
        self._wire_dtype = np.dtype(meta["wire_dtype"])

    @classmethod
    def load(cls, path: str, device=None) -> "ArtifactPredictor":
        """``device``: None means CUDA."""
        return cls(load_serving(path, device=device))

    def warmup(self, dtype=None) -> None:
        self.fetch_local(self.dispatch(np.zeros(
            (self.batch_size, self.img_size, self.img_size, 3),
            self._wire_dtype if dtype is None else dtype)))

    def dispatch(self, images: np.ndarray):
        """[n <= batch_size, S, S, 3] wire-dtype batch -> the program's
        outputs (detections, valid[, relevant_count]) with their host
        copies in flight (engine/predictor.Dispatched)."""
        if images.dtype != self._wire_dtype:
            raise ValueError(f"expected {self._wire_dtype} images "
                             f"(exported wire dtype), got {images.dtype}")
        with device_scope(self.device):
            x = upload_nhwc(images, self.batch_size, self.device)
            return start_fetch(self.artifact.call(nhwc_to_wire(x)),
                               self.device)

    fetch_local = staticmethod(fetch_local)
