"""Detection postprocess in plain PyTorch: a frozen copy of the program's
plain path (the reference's yolo/util/utils.py:92-223 in fixed shapes).

1. every (box, class) pair with obj * cls >= conf_thre is a candidate;
2. the top K boxes by their best pair, then the top K pairs among them;
3. class-wise greedy NMS at IoU >= nms_thre over class-offset boxes, the
   offset span being the whole batch's largest coordinate (so a row's
   detections depend on its batchmates, as in the program);
4. the top ``max_dets`` survivors, score-sorted, zeros where invalid.

Rows: x1, y1, x2, y2, obj, cls_conf, cls. The greedy NMS here is the
sequential textbook loop, one image at a time.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def cxcywh_to_xyxy(b: torch.Tensor) -> torch.Tensor:
    half = b[..., 2:4] / 2
    return torch.cat([b[..., :2] - half, b[..., :2] + half], -1)


def iou_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU [N, M] of xyxy boxes a [N, 4] and b [M, 4]; an intersection
    counts only where top-left < bottom-right on both axes."""
    tl = torch.maximum(a[:, None, :2], b[None, :, :2])
    br = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = torch.prod(br - tl, -1) * torch.prod((tl < br).float(), -1)
    area_a = torch.prod(a[:, 2:] - a[:, :2], -1)
    area_b = torch.prod(b[:, 2:] - b[:, :2], -1)
    union = area_a[:, None] + area_b[None, :] - inter
    return inter / torch.clamp(union, min=1e-9)


def greedy_nms(boxes: torch.Tensor, valid: torch.Tensor,
               thresh: float) -> torch.Tensor:
    """keep [K] for one image's score-sorted boxes [K, 4]: a valid box is
    kept unless a kept box before it overlaps it at IoU >= thresh."""
    k = boxes.shape[0]
    hits = torch.triu(iou_matrix(boxes, boxes) >= thresh, 1).cpu().numpy()
    removed = ~valid.cpu().numpy()
    keep = np.zeros(k, bool)
    for i in range(k):
        if not removed[i]:
            keep[i] = True
            removed |= hits[i]
    return torch.from_numpy(keep).to(boxes.device)


@torch.no_grad()
def postprocess(pred: torch.Tensor, num_classes: int, conf_thre: float,
                nms_thre: float, pre_nms_topk: int = 2048,
                max_dets: int = 100) -> Tuple[torch.Tensor, torch.Tensor]:
    """pred [B, N, 5+C] -> (detections [B, max_dets, 7], valid)."""
    pred = pred.float()
    b, n, _ = pred.shape
    obj = pred[..., 4]
    cls = pred[..., 5:5 + num_classes]
    kb = min(pre_nms_topk, n)
    _, box_sel = torch.topk(obj * cls.amax(-1), kb, dim=-1)
    rows = torch.gather(pred, 1, box_sel[..., None].expand(-1, -1,
                                                           pred.shape[-1]))
    boxes_kb = cxcywh_to_xyxy(rows[..., :4])
    pair = rows[..., 4:5] * rows[..., 5:5 + num_classes]
    flat = pair.reshape(b, kb * num_classes)
    flat = torch.where(flat >= conf_thre, flat, torch.full_like(flat, -1.0))
    k = min(pre_nms_topk, kb * num_classes)
    top, idx = torch.topk(flat, k, dim=-1)
    valid = top >= conf_thre
    box_local, cls_idx = idx // num_classes, idx % num_classes
    boxes = torch.gather(boxes_kb, 1, box_local[..., None].expand(-1, -1, 4))
    sel_obj = torch.gather(rows[..., 4], 1, box_local)
    cls_conf = top / torch.clamp(sel_obj, min=1e-16)
    span = 2.0 * boxes.abs().amax() + 1.0
    offset = boxes + (cls_idx.float() * span)[..., None]
    keep = torch.stack([greedy_nms(offset[i], valid[i], nms_thre)
                        for i in range(b)])
    kept = torch.where(keep, top, torch.full_like(top, -1.0))
    final, order = torch.topk(kept, min(max_dets, k), dim=-1)
    fvalid = final > 0.0

    def take(x):
        return torch.gather(x, 1, order)

    det = torch.cat([torch.gather(boxes, 1, order[..., None].expand(-1, -1,
                                                                    4)),
                     take(sel_obj)[..., None], take(cls_conf)[..., None],
                     take(cls_idx.float())[..., None]], -1)
    det = torch.where(fvalid[..., None], det, torch.zeros_like(det))
    return det, fvalid
