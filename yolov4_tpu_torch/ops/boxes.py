"""Box geometry (torch, batched) and the host-side unmap helper (numpy).

Semantics match the reference so that loss and postprocess numerics are
reproducible:
  * pairwise IoU: reference yolo/model/yololoss.py:16-91 (``bboxes_iou``),
    including the strict ``tl < br`` intersection-validity product;
  * tlwh->xyxy / xyxy->cxcywh: reference yolo/data/transform.py:332-356;
  * the IoU / GIoU / DIoU / CIoU of matched pairs behind the opt-in
    ``CRITERION.BOX_LOSS`` variants;
  * resized-image -> source-image unmapping: reference
    yolo/util/utils.py:281-340 (``yolobox2xywh``, ``yolobox2yxyx``).
"""

from __future__ import annotations

import math

import numpy as np
import torch


def tlwh_to_xyxy(boxes: torch.Tensor) -> torch.Tensor:
    """[..., 4] tlwh -> xyxy."""
    return torch.cat([boxes[..., :2], boxes[..., :2] + boxes[..., 2:4]],
                     dim=-1)


def xyxy_to_tlwh(boxes: torch.Tensor) -> torch.Tensor:
    """[..., 4] xyxy -> tlwh."""
    return torch.cat([boxes[..., :2], boxes[..., 2:4] - boxes[..., :2]],
                     dim=-1)


def xyxy_to_cxcywh(boxes: torch.Tensor) -> torch.Tensor:
    """[..., 4] xyxy -> cxcywh (reference transform.py:345)."""
    return torch.cat([(boxes[..., :2] + boxes[..., 2:4]) / 2,
                      boxes[..., 2:4] - boxes[..., :2]], dim=-1)


def cxcywh_to_xyxy(boxes: torch.Tensor) -> torch.Tensor:
    """[..., 4] cxcywh -> xyxy (reference utils.py:117-126)."""
    half = boxes[..., 2:4] / 2
    return torch.cat([boxes[..., :2] - half, boxes[..., :2] + half], dim=-1)


def iou_pairwise_safe(boxes_a: torch.Tensor, boxes_b: torch.Tensor,
                      eps: float = 1e-9, fmt: str = "xyxy") -> torch.Tensor:
    """Pairwise IoU [..., N, K] between boxes [..., N, 4] and [..., K, 4],
    both ``xyxy`` or both ``cxcywh`` (reference bboxes_iou xyxy=True /
    False).

    An intersection only counts when top-left is strictly less than
    bottom-right in BOTH axes (reference yololoss.py:77); the union is
    clamped to ``eps`` so degenerate or padded boxes give 0, not NaN.
    """
    if fmt == "xyxy":
        a_tl, a_br = boxes_a[..., :2], boxes_a[..., 2:4]
        b_tl, b_br = boxes_b[..., :2], boxes_b[..., 2:4]
        area_a = torch.prod(a_br - a_tl, dim=-1)
        area_b = torch.prod(b_br - b_tl, dim=-1)
    elif fmt == "cxcywh":
        a_tl = boxes_a[..., :2] - boxes_a[..., 2:4] / 2
        a_br = boxes_a[..., :2] + boxes_a[..., 2:4] / 2
        b_tl = boxes_b[..., :2] - boxes_b[..., 2:4] / 2
        b_br = boxes_b[..., :2] + boxes_b[..., 2:4] / 2
        area_a = torch.prod(boxes_a[..., 2:4], dim=-1)
        area_b = torch.prod(boxes_b[..., 2:4], dim=-1)
    else:
        raise ValueError(f"unknown box format: {fmt}")
    tl = torch.maximum(a_tl[..., :, None, :], b_tl[..., None, :, :])
    br = torch.minimum(a_br[..., :, None, :], b_br[..., None, :, :])
    valid = torch.prod((tl < br).to(boxes_a.dtype), dim=-1)
    inter = torch.prod(br - tl, dim=-1) * valid
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / torch.clamp(union, min=eps)


def iou_variant_elementwise(pred: torch.Tensor, gt: torch.Tensor,
                            kind: str = "iou",
                            eps: float = 1e-9) -> torch.Tensor:
    """IoU / GIoU / DIoU / CIoU between matched cxcywh pairs [..., 4] of
    the same shape -> [...] (Zheng et al., AAAI 2020):

      giou = iou - (C - U) / C     C = enclosing-box area
      diou = iou - rho^2 / c^2     rho = centre distance, c = enclosing
                                   diagonal
      ciou = diou - alpha * v      v = (4/pi^2) (atan(w/h) difference)^2,
                                   alpha = v / ((1 - iou) + v), a constant
                                   in the gradient

    Every denominator is eps-guarded: masked cells carry zero boxes and
    the loss multiplies by the mask afterwards, where a NaN would survive
    (NaN * 0 = NaN).
    """
    if kind not in ("iou", "giou", "diou", "ciou"):
        raise ValueError(f"unknown IoU variant: {kind!r}")
    p_tl = pred[..., :2] - pred[..., 2:4] / 2
    p_br = pred[..., :2] + pred[..., 2:4] / 2
    g_tl = gt[..., :2] - gt[..., 2:4] / 2
    g_br = gt[..., :2] + gt[..., 2:4] / 2

    wh = torch.clamp(torch.minimum(p_br, g_br) - torch.maximum(p_tl, g_tl),
                     min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = pred[..., 2] * pred[..., 3] + gt[..., 2] * gt[..., 3] - inter
    iou = inter / torch.clamp(union, min=eps)
    if kind == "iou":
        return iou

    c_wh = torch.clamp(torch.maximum(p_br, g_br) - torch.minimum(p_tl, g_tl),
                       min=0.0)
    if kind == "giou":
        c_area = c_wh[..., 0] * c_wh[..., 1]
        return iou - (c_area - union) / torch.clamp(c_area, min=eps)

    rho2 = (torch.square(pred[..., 0] - gt[..., 0])
            + torch.square(pred[..., 1] - gt[..., 1]))
    c2 = torch.square(c_wh[..., 0]) + torch.square(c_wh[..., 1])
    diou = iou - rho2 / torch.clamp(c2, min=eps)
    if kind == "diou":
        return diou

    v = (4.0 / math.pi ** 2) * torch.square(
        torch.atan(gt[..., 2] / torch.clamp(gt[..., 3], min=eps))
        - torch.atan(pred[..., 2] / torch.clamp(pred[..., 3], min=eps)))
    alpha = (v / torch.clamp((1.0 - iou) + v, min=eps)).detach()
    return diou - alpha * v


def unmap_to_source_tlwh(boxes_xyxy, src_hw, dst_hw,
                         offset_xy=(0.0, 0.0)) -> np.ndarray:
    """xyxy boxes in the resized image -> COCO tlwh in the source image
    (reference utils.py:281-309 ``yolobox2xywh``); the JAX package's
    ops/boxes.py helper, operation for operation.

    Pure numpy, on fetched detections. ``dst_hw`` is the content size and
    ``offset_xy`` the letterbox padding, as in unmap_to_source_xyxy.
    """
    boxes_xyxy = np.asarray(boxes_xyxy)
    src_h, src_w = src_hw
    dst_h, dst_w = dst_hw
    off_x, off_y = offset_xy
    x1 = (boxes_xyxy[..., 0] - off_x) / dst_w * src_w
    y1 = (boxes_xyxy[..., 1] - off_y) / dst_h * src_h
    w = (boxes_xyxy[..., 2] - boxes_xyxy[..., 0]) / dst_w * src_w
    h = (boxes_xyxy[..., 3] - boxes_xyxy[..., 1]) / dst_h * src_h
    return np.stack([x1, y1, w, h], axis=-1)


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
