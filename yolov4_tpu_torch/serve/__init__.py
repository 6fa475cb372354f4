"""Serving runtime of the port: dynamic batching onto static-shape device
batches, multi-size buckets sharing one model, metrics, an HTTP front end,
and serving from exported single-file artifacts. ``python -m
yolov4_tpu_torch.serve`` is the CLI (serve/__main__.py)."""

from yolov4_tpu_torch.serve.artifact import ArtifactPredictor
from yolov4_tpu_torch.serve.batcher import DetectionResult, DynamicBatcher
from yolov4_tpu_torch.serve.metrics import ServeMetrics
from yolov4_tpu_torch.serve.server import (ServingRuntime, make_server,
                                           result_to_json, serve_background)

__all__ = [
    "ArtifactPredictor", "DetectionResult", "DynamicBatcher",
    "ServeMetrics", "ServingRuntime", "make_server", "result_to_json",
    "serve_background",
]
