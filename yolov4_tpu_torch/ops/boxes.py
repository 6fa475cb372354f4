"""Box geometry (torch, batched) and the host-side unmap helper (numpy).

Semantics match the reference so that postprocess numerics are
reproducible:
  * pairwise IoU: reference yolo/model/yololoss.py:16-91 (``bboxes_iou``),
    including the strict ``tl < br`` intersection-validity product;
  * resized-image -> source-image unmapping: reference
    yolo/util/utils.py:312-340 (``yolobox2yxyx``).
"""

from __future__ import annotations

import numpy as np
import torch


def cxcywh_to_xyxy(boxes: torch.Tensor) -> torch.Tensor:
    """[..., 4] cxcywh -> xyxy (reference utils.py:117-126)."""
    half = boxes[..., 2:4] / 2
    return torch.cat([boxes[..., :2] - half, boxes[..., :2] + half], dim=-1)


def iou_pairwise_safe(boxes_a: torch.Tensor, boxes_b: torch.Tensor,
                      eps: float = 1e-9) -> torch.Tensor:
    """Pairwise IoU [..., N, K] between xyxy boxes [..., N, 4] and
    [..., K, 4].

    An intersection only counts when top-left is strictly less than
    bottom-right in BOTH axes (reference yololoss.py:77); the union is
    clamped to ``eps`` so degenerate or padded boxes give 0, not NaN.
    """
    a_tl, a_br = boxes_a[..., :2], boxes_a[..., 2:4]
    b_tl, b_br = boxes_b[..., :2], boxes_b[..., 2:4]
    area_a = torch.prod(a_br - a_tl, dim=-1)
    area_b = torch.prod(b_br - b_tl, dim=-1)
    tl = torch.maximum(a_tl[..., :, None, :], b_tl[..., None, :, :])
    br = torch.minimum(a_br[..., :, None, :], b_br[..., None, :, :])
    valid = torch.prod((tl < br).to(boxes_a.dtype), dim=-1)
    inter = torch.prod(br - tl, dim=-1) * valid
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / torch.clamp(union, min=eps)


def unmap_to_source_xyxy(boxes_xyxy, src_hw, dst_hw,
                         offset_xy=(0.0, 0.0)) -> np.ndarray:
    """xyxy boxes in the resized image -> xyxy in the source image
    (reference utils.py:312-340 ``yolobox2yxyx``, reordered to xyxy).

    Pure numpy: it runs on the host, on fetched detections.
    ``dst_hw`` is the content size (scaled image without padding; the
    whole canvas for stretch-resize) and ``offset_xy`` the letterbox
    padding, subtracted before scaling.
    """
    boxes_xyxy = np.asarray(boxes_xyxy)
    src_h, src_w = src_hw
    dst_h, dst_w = dst_hw
    off_x, off_y = offset_xy
    x1 = (boxes_xyxy[..., 0] - off_x) * src_w / dst_w
    y1 = (boxes_xyxy[..., 1] - off_y) * src_h / dst_h
    x2 = (boxes_xyxy[..., 2] - off_x) * src_w / dst_w
    y2 = (boxes_xyxy[..., 3] - off_y) * src_h / dst_h
    return np.stack([x1, y1, x2, y2], axis=-1)
