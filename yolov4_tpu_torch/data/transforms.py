"""Eval-time image transforms (reference yolo/data/transform.py:173-187,
429-448): BGR->RGB and a stretch resize to the square input size, or the
opt-in aspect-preserving letterbox. Images are scaled by 1/255 only (no
mean/std), on the host or, with ``keep_uint8``, on the device.

Port of the val path of the JAX package's data/transforms.py; the train
augmentations wait for the training slice.
"""

from __future__ import annotations

from typing import Dict

import cv2
import numpy as np


def tlwh_to_xyxy_np(bboxes: np.ndarray) -> np.ndarray:
    if len(bboxes) == 0:
        return bboxes
    out = bboxes.copy()
    out[:, 2] = bboxes[:, 0] + bboxes[:, 2]
    out[:, 3] = bboxes[:, 1] + bboxes[:, 3]
    return out


def xyxy_to_cxcywh_np(bboxes: np.ndarray) -> np.ndarray:
    if len(bboxes) == 0:
        return bboxes
    out = bboxes.copy()
    out[:, 0] = (bboxes[:, 0] + bboxes[:, 2]) / 2
    out[:, 1] = (bboxes[:, 1] + bboxes[:, 3]) / 2
    out[:, 2] = bboxes[:, 2] - bboxes[:, 0]
    out[:, 3] = bboxes[:, 3] - bboxes[:, 1]
    return out


def stretch_resize(img: np.ndarray, bboxes: np.ndarray, dst_size: int):
    """Aspect-distorting resize to dst_size x dst_size (transform.py:173-187)."""
    src_h, src_w = img.shape[:2]
    out = cv2.resize(img, (dst_size, dst_size), interpolation=cv2.INTER_LINEAR)
    if len(bboxes) > 0:
        bboxes = bboxes.copy()
        bboxes[:, [0, 2]] *= dst_size / src_w
        bboxes[:, [1, 3]] *= dst_size / src_h
    return out, bboxes


def letterbox_resize(img: np.ndarray, bboxes: np.ndarray, dst_size: int,
                     pad_value: int = 127):
    """Aspect-preserving resize + centred gray padding (the geometry of the
    reference's unused ``resize_and_pad``, transform.py:19-70).

    bboxes are xyxy pixel boxes. Returns (canvas, boxes, img_info) with
    img_info = [src_h, src_w, content_h, content_w, off_x, off_y].
    """
    src_h, src_w = img.shape[:2]
    scale = min(dst_size / src_h, dst_size / src_w)
    content_w, content_h = int(src_w * scale), int(src_h * scale)
    off_x = (dst_size - content_w) // 2
    off_y = (dst_size - content_h) // 2
    resized = cv2.resize(img, (content_w, content_h),
                         interpolation=cv2.INTER_LINEAR)
    canvas = np.full((dst_size, dst_size, 3), pad_value, img.dtype)
    canvas[off_y:off_y + content_h, off_x:off_x + content_w] = resized
    if len(bboxes) > 0:
        bboxes = bboxes.copy()
        bboxes[:, [0, 2]] = bboxes[:, [0, 2]] * (content_w / src_w) + off_x
        bboxes[:, [1, 3]] = bboxes[:, [1, 3]] * (content_h / src_h) + off_y
    return canvas, bboxes, [src_h, src_w, content_h, content_w, off_x, off_y]


class Transform:
    """Val preprocessing (reference transform.py:359-481, eval branch).

    __call__([img_bgr], [bboxes_tlwh_cls], img_size) -> (img HWC, target)
    where img is float32 in [0, 1], or uint8 with ``keep_uint8`` (the
    device normalizes), and target holds 'padded_labels' [MAX_NUM_LABELS, 5]
    float32 cxcywh+cls rows and 'img_info' = [src_h, src_w, content_h,
    content_w, off_x, off_y].
    """

    def __init__(self, cfg: Dict, keep_uint8: bool = False):
        self.keep_uint8 = keep_uint8
        self.max_num_labels = cfg["DATA"]["MAX_NUM_LABELS"]
        self.letterbox = bool(cfg.get("TEST", {}).get("LETTERBOX", False))

    def __call__(self, img_list, bboxes_list, img_size: int):
        if len(img_list) != 1 or len(bboxes_list) != 1:
            raise ValueError("the val transform takes one image at a time")
        src = img_list[0]
        img = src[:, :, ::-1]  # BGR -> RGB
        if self.letterbox:
            bboxes = tlwh_to_xyxy_np(np.asarray(bboxes_list[0], np.float64))
            img, bboxes, img_info = letterbox_resize(img, bboxes, img_size)
        else:
            img, bboxes = stretch_resize(
                img, np.asarray(bboxes_list[0], np.float64), img_size)
            img_info = [src.shape[0], src.shape[1],
                        img.shape[0], img.shape[1], 0, 0]
            bboxes = tlwh_to_xyxy_np(bboxes)

        if self.keep_uint8:
            img = np.ascontiguousarray(img, dtype=np.uint8)
        else:
            img = np.ascontiguousarray(img, dtype=np.float32) / 255.0

        padded = np.zeros((self.max_num_labels, 5), np.float32)
        if len(bboxes) > 0:
            bboxes = xyxy_to_cxcywh_np(np.asarray(bboxes))
            n = min(len(bboxes), self.max_num_labels)
            padded[:n] = bboxes[:n]
        return img, {"padded_labels": padded, "img_info": img_info}
