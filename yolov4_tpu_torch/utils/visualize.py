"""Detection drawing (reference detect.py:188-228 show_bbox), with the
port's own copy of the COCO label tables (reference cocodataset.py:24-55)."""

from __future__ import annotations

from typing import Sequence

import cv2
import numpy as np

COCO_LABEL_NAMES = (
    "background",
    "person", "bicycle", "car", "motorcycle", "airplane", "bus", "train",
    "truck", "boat", "traffic light", "fire hydrant", "street sign",
    "stop sign", "parking meter", "bench", "bird", "cat", "dog", "horse",
    "sheep", "cow", "elephant", "bear", "zebra", "giraffe", "hat",
    "backpack", "umbrella", "shoe", "eye glasses", "handbag", "tie",
    "suitcase", "frisbee", "skis", "snowboard", "sports ball", "kite",
    "baseball bat", "baseball glove", "skateboard", "surfboard",
    "tennis racket", "bottle", "plate", "wine glass", "cup", "fork",
    "knife", "spoon", "bowl", "banana", "apple", "sandwich", "orange",
    "broccoli", "carrot", "hot dog", "pizza", "donut", "cake", "chair",
    "couch", "potted plant", "bed", "mirror", "dining table", "window",
    "desk", "toilet", "door", "tv", "laptop", "mouse", "remote",
    "keyboard", "cell phone", "microwave", "oven", "toaster", "sink",
    "refrigerator", "blender", "book", "clock", "vase", "scissors",
    "teddy bear", "hair drier", "toothbrush",
)

# model class index (0..79) -> COCO category id
COCO_CLASS_IDS = [
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 14, 15, 16, 17, 18, 19, 20,
    21, 22, 23, 24, 25, 27, 28, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40,
    41, 42, 43, 44, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 67, 70, 72, 73, 74, 75, 76, 77, 78, 79,
    80, 81, 82, 84, 85, 86, 87, 88, 89, 90,
]

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
