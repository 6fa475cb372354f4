"""YOLOv4 model: backbone, neck, head and anchor decoding."""

from yolov4_tpu_torch.models.yolov4 import YOLOv4, build_model

__all__ = ["YOLOv4", "build_model"]
