"""Image/label transforms (reference yolo/data/transform.py:19-481): the
port's copy of the JAX package's data/transforms.py.

Train path: BGR->RGB, jittered crop with per-channel-mean padding, random
horizontal flip, stretch resize to the square input size, HSV colour
dithering, 4-image mosaic. Val path: BGR->RGB and a stretch resize, or the
opt-in aspect-preserving letterbox. Images are scaled by 1/255 only (no
mean/std), on the host or, with ``keep_uint8`` (val only), on the device.

The train path's randomness is the JAX package's draw for draw (the same
generator kinds in the same order: ``random.Random`` and
``np.random.RandomState``), so one seed gives bit-equal batches in both.
Quirks kept from the reference:
  * horizontal flip fires on ``randn() > 0.5``, probability ~0.31
    (transform.py:158);
  * crop padding is the per-image channel mean (transform.py:110-111);
  * colour dithering returns float32 (transform.py:244).
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional, Tuple

import cv2
import numpy as np


def _rect_intersection(a, b):
    return [max(a[0], b[0]), max(a[1], b[1]), min(a[2], b[2]), min(a[3], b[3])]


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


def crop_and_pad(img: np.ndarray, bboxes: np.ndarray, jitter_ratio: float,
                 py_rng: random.Random, np_rng: np.random.RandomState):
    """Random jittered crop with channel-mean padding
    (reference transform.py:81-152)."""
    src_h, src_w = img.shape[:2]
    jitter_h = int(src_h * jitter_ratio)
    jitter_w = int(src_w * jitter_ratio)
    crop_left = py_rng.randint(-jitter_w, jitter_w)
    crop_right = py_rng.randint(-jitter_w, jitter_w)
    crop_top = py_rng.randint(-jitter_h, jitter_h)
    crop_bottom = py_rng.randint(-jitter_h, jitter_h)

    crop_h = src_h - crop_top - crop_bottom
    crop_w = src_w - crop_left - crop_right

    crop_rect = [crop_left, crop_top, crop_left + crop_w, crop_top + crop_h]
    inter = _rect_intersection(crop_rect, [0, 0, src_w, src_h])
    iw, ih = inter[2] - inter[0], inter[3] - inter[1]
    dst_x, dst_y = max(0, -crop_left), max(0, -crop_top)

    out = np.zeros([crop_h, crop_w, 3])
    out[:, :, :] = np.mean(img, axis=(0, 1))
    out[dst_y:dst_y + ih, dst_x:dst_x + iw] = \
        img[inter[1]:inter[3], inter[0]:inter[2]]

    if len(bboxes) != 0:
        if bboxes.shape[1] != 5:
            raise ValueError(f"boxes must be [N, 5], got {bboxes.shape}")
        np_rng.shuffle(bboxes)
        bboxes = bboxes.copy()
        bboxes[:, [0, 2]] -= crop_left
        bboxes[:, [1, 3]] -= crop_top
        bboxes[:, [0, 2]] = np.clip(bboxes[:, [0, 2]], 0, crop_w)
        bboxes[:, [1, 3]] = np.clip(bboxes[:, [1, 3]], 0, crop_h)
        degenerate = (
            ((bboxes[:, 1] == crop_h) & (bboxes[:, 3] == crop_h))
            | ((bboxes[:, 0] == crop_w) & (bboxes[:, 2] == crop_w))
            | ((bboxes[:, 1] == 0) & (bboxes[:, 3] == 0))
            | ((bboxes[:, 0] == 0) & (bboxes[:, 2] == 0))
        )
        bboxes = bboxes[~degenerate]

    crop_info = [crop_left, crop_right, crop_top, crop_bottom, crop_w, crop_h]
    return out, bboxes, crop_info


def left_right_flip(img: np.ndarray, bboxes: np.ndarray, enabled: bool,
                    np_rng: np.random.RandomState):
    """Horizontal flip with the reference's randn() > 0.5 gate
    (transform.py:155-170)."""
    is_flip = enabled and np_rng.randn() > 0.5
    if is_flip:
        img = np.flip(img, axis=1).copy()
        w = img.shape[1]
        if len(bboxes) > 0:
            x2 = w - bboxes[:, 0]
            bboxes[:, 0] = w - bboxes[:, 2]
            bboxes[:, 2] = x2
    return img, bboxes, bool(is_flip)


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



def _rand_uniform_strong(lo: float, hi: float, py_rng: random.Random) -> float:
    if lo > hi:
        lo, hi = hi, lo
    return py_rng.random() * (hi - lo) + lo


def _rand_scale(s: float, py_rng: random.Random) -> float:
    scale = _rand_uniform_strong(1, s, py_rng)
    if py_rng.randint(0, 1) % 2:
        return scale
    return 1.0 / scale


def color_dithering(img: np.ndarray, hue: float, saturation: float,
                    exposure: float, enabled: bool,
                    py_rng: random.Random) -> np.ndarray:
    """HSV jitter (transform.py:211-245). Returns float32 when enabled."""
    if not enabled:
        return img
    dhue = _rand_uniform_strong(-hue, hue, py_rng)
    dsat = _rand_scale(saturation, py_rng)
    dexp = _rand_scale(exposure, py_rng)

    img = img.astype(np.float32)
    if dsat != 1 or dexp != 1 or dhue != 0:
        if img.shape[2] >= 3:
            hsv = list(cv2.split(cv2.cvtColor(img, cv2.COLOR_RGB2HSV)))
            hsv[1] *= dsat
            hsv[2] *= dexp
            hsv[0] += 179 * dhue
            img = np.clip(cv2.cvtColor(cv2.merge(hsv), cv2.COLOR_HSV2RGB),
                          0, 255)
        else:
            img *= dexp
    return img


def filter_truth(bboxes: np.ndarray, dx, dy, sx, sy, xd, yd) -> np.ndarray:
    """Shift boxes into a mosaic quadrant, clip, drop degenerates
    (transform.py:248-284)."""
    if len(bboxes) <= 0:
        return bboxes
    bboxes = bboxes.copy()
    bboxes[:, [0, 2]] -= dx
    bboxes[:, [1, 3]] -= dy
    bboxes[:, [0, 2]] = np.clip(bboxes[:, [0, 2]], 0, sx)
    bboxes[:, [1, 3]] = np.clip(bboxes[:, [1, 3]], 0, sy)
    degenerate = (
        ((bboxes[:, 1] == sy) & (bboxes[:, 3] == sy))
        | ((bboxes[:, 0] == sx) & (bboxes[:, 2] == sx))
        | ((bboxes[:, 1] == 0) & (bboxes[:, 3] == 0))
        | ((bboxes[:, 0] == 0) & (bboxes[:, 2] == 0))
    )
    bboxes = bboxes[~degenerate]
    bboxes[:, [0, 2]] += xd
    bboxes[:, [1, 3]] += yd
    return bboxes


def blend_mosaic(out_img: np.ndarray, img: np.ndarray, bboxes: np.ndarray,
                 cut_x: int, cut_y: int, mosaic_idx: int, crop_info) -> Tuple:
    """Paste one image into a mosaic quadrant (transform.py:287-329)."""
    crop_left, crop_right, crop_top, crop_bottom, crop_w, crop_h, is_flip = \
        crop_info[:7]
    if is_flip:
        crop_left, crop_right = crop_right, crop_left
    img_h, img_w = img.shape[:2]

    left_shift = int(min(cut_x, max(0, (-int(crop_left) * img_w / crop_w))))
    top_shift = int(min(cut_y, max(0, (-int(crop_top) * img_h / crop_h))))
    right_shift = int(min(img_w - cut_x,
                          max(0, (-int(crop_right) * img_w / crop_w))))
    bottom_shift = int(min(img_h - cut_y,
                           max(0, (-int(crop_bottom) * img_h / crop_h))))

    left_shift = min(left_shift, img_w - cut_x)
    top_shift = min(top_shift, img_h - cut_y)
    right_shift = min(right_shift, cut_x)
    bottom_shift = min(bottom_shift, cut_y)

    if mosaic_idx == 0:
        bboxes = filter_truth(bboxes, left_shift, top_shift, cut_x, cut_y, 0, 0)
        out_img[:cut_y, :cut_x] = img[top_shift:top_shift + cut_y,
                                      left_shift:left_shift + cut_x]
    elif mosaic_idx == 1:
        bboxes = filter_truth(bboxes, cut_x - right_shift, top_shift,
                              img_w - cut_x, cut_y, cut_x, 0)
        out_img[:cut_y, cut_x:] = img[top_shift:top_shift + cut_y,
                                      cut_x - right_shift:img_w - right_shift]
    elif mosaic_idx == 2:
        bboxes = filter_truth(bboxes, left_shift, cut_y - bottom_shift,
                              cut_x, img_h - cut_y, 0, cut_y)
        out_img[cut_y:, :cut_x] = img[cut_y - bottom_shift:img_h - bottom_shift,
                                      left_shift:left_shift + cut_x]
    elif mosaic_idx == 3:
        bboxes = filter_truth(bboxes, cut_x - right_shift, cut_y - bottom_shift,
                              img_w - cut_x, img_h - cut_y, cut_x, cut_y)
        out_img[cut_y:, cut_x:] = img[cut_y - bottom_shift:img_h - bottom_shift,
                                      cut_x - right_shift:img_w - right_shift]
    return out_img, bboxes


class Transform:
    """Train/val preprocessing (reference transform.py:359-481).

    __call__(img_list, bboxes_list, img_size) -> (img HWC, target) where
    ``img_list`` holds BGR images (four with mosaic, else one),
    ``bboxes_list`` [N, 5] tlwh+cls rows each, img is float32 in [0, 1] or
    uint8 with ``keep_uint8`` (val only: the device normalizes), and
    target holds 'padded_labels' [MAX_NUM_LABELS, 5] float32 cxcywh+cls
    rows and 'img_info' (val: [src_h, src_w, content_h, content_w, off_x,
    off_y]; train: []). The port's default is the val path (its first
    callers were eval's); the JAX package's is train.
    """

    def __init__(self, cfg: Dict, is_train: bool = False,
                 seed: Optional[int] = None, keep_uint8: bool = False):
        self.is_train = is_train
        self.keep_uint8 = keep_uint8 and not is_train
        aug = cfg["AUGMENTATION"]
        self.jitter_ratio = aug["JITTER"]
        self.is_flip = aug["RANDOM_HORIZONTAL_FLIP"]
        self.color_jitter = aug["COLOR_DITHERING"]
        self.hue = aug["HUE"]
        self.saturation = aug["SATURATION"]
        self.exposure = aug["EXPOSURE"]
        self.is_mosaic = aug["IS_MOSAIC"]
        self.min_offset = aug["MIN_OFFSET"]
        self.max_num_labels = cfg["DATA"]["MAX_NUM_LABELS"]
        self.letterbox = bool(cfg.get("TEST", {}).get("LETTERBOX", False))
        self.seed(seed)

    def seed(self, seed: Optional[int]) -> None:
        self._py_rng = random.Random(seed)
        self._np_rng = (np.random.RandomState(seed) if seed is not None
                        else np.random.RandomState())

    def _train_item(self, img_list: List[np.ndarray],
                    bboxes_list: List[np.ndarray], img_size: int):
        expected = 4 if self.is_mosaic else 1
        if len(img_list) != expected or len(bboxes_list) != expected:
            raise ValueError(f"the train transform takes {expected} images "
                             f"(IS_MOSAIC {self.is_mosaic}), got "
                             f"{len(img_list)}")
        out_img = np.zeros([img_size, img_size, 3])
        out_bboxes: List[np.ndarray] = []

        cut_x = self._py_rng.randint(int(img_size * self.min_offset),
                                     int(img_size * (1 - self.min_offset)))
        cut_y = self._py_rng.randint(int(img_size * self.min_offset),
                                     int(img_size * (1 - self.min_offset)))

        for idx, (img, bboxes) in enumerate(zip(img_list, bboxes_list)):
            bboxes = tlwh_to_xyxy_np(np.asarray(bboxes, dtype=np.float64))
            img = img[:, :, ::-1]  # BGR -> RGB
            img, bboxes, crop_info = crop_and_pad(
                img, bboxes, self.jitter_ratio, self._py_rng, self._np_rng)
            img, bboxes, flipped = left_right_flip(
                img, bboxes, self.is_flip, self._np_rng)
            crop_info.append(flipped)
            img, bboxes = stretch_resize(img, bboxes, img_size)
            img = color_dithering(img, self.hue, self.saturation,
                                  self.exposure, self.color_jitter,
                                  self._py_rng)
            if self.is_mosaic:
                out_img, bboxes = blend_mosaic(
                    out_img, img, bboxes, cut_x, cut_y, idx, crop_info)
                if len(bboxes) > 0:
                    out_bboxes.append(bboxes)
            else:
                out_img = img
                out_bboxes = bboxes

        if self.is_mosaic and len(out_bboxes) > 0:
            out_bboxes = np.concatenate(out_bboxes, axis=0)
        return out_img, out_bboxes, []

    def _val_item(self, img_list, bboxes_list, img_size: int):
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
        return img, bboxes, img_info

    def __call__(self, img_list, bboxes_list, img_size: int):
        item = self._train_item if self.is_train else self._val_item
        img, bboxes, img_info = item(img_list, bboxes_list, img_size)

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
