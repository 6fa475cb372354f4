"""Detection drawing (reference detect.py:188-228 show_bbox)."""

from __future__ import annotations

from typing import Sequence

import cv2
import numpy as np

from yolov4_tpu_torch.data.coco import COCO_CLASS_IDS, COCO_LABEL_NAMES

_COLORS = np.random.RandomState(12345).randint(96, 255, size=(80, 3))


def class_name(cls_idx: int) -> str:
    """Model class index (0..79) -> COCO label name; other indices get a
    generic name (the standard 80-class table, like the reference)."""
    i = int(cls_idx)
    if not 0 <= i < len(COCO_CLASS_IDS):
        return f"class_{i}"
    return COCO_LABEL_NAMES[COCO_CLASS_IDS[i]]


def draw_detections(img_bgr: np.ndarray, boxes_xyxy: np.ndarray,
                    scores: Sequence[float], cls_idxs: Sequence[int],
                    thickness: int = 2) -> np.ndarray:
    """Draw labelled boxes on a BGR uint8 image (in place) and return it."""
    h, w = img_bgr.shape[:2]
    for box, score, cls_idx in zip(boxes_xyxy, scores, cls_idxs):
        x1, y1, x2, y2 = [int(round(float(v))) for v in box]
        x1, x2 = np.clip([x1, x2], 0, w - 1)
        y1, y2 = np.clip([y1, y2], 0, h - 1)
        color = tuple(int(c) for c in _COLORS[int(cls_idx) % 80])
        cv2.rectangle(img_bgr, (x1, y1), (x2, y2), color, thickness)
        label = f"{class_name(cls_idx)} {float(score):.2f}"
        (tw, th), baseline = cv2.getTextSize(label, cv2.FONT_HERSHEY_SIMPLEX, 0.5, 1)
        ty = max(y1, th + baseline)
        cv2.rectangle(img_bgr, (x1, ty - th - baseline), (x1 + tw, ty), color, -1)
        cv2.putText(img_bgr, label, (x1, ty - baseline // 2),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.5, (0, 0, 0), 1, cv2.LINE_AA)
    return img_bgr
