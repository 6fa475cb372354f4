"""Detection postprocessing on the device (conf filter + class-wise NMS).

Port of the JAX package's ops/postprocess.py, itself a fixed-shape rebuild
of the reference's per-image loops (yolo/util/utils.py:92-223):

  1. multi-label expansion: every (box, class) pair with
     obj * cls_prob >= conf_thre is a candidate (utils.py:145,170);
  2. two-stage top-K: the top K boxes by their best pair score, then the
     top K pairs among those boxes (exact whenever <= K boxes carry an
     above-threshold pair);
  3. class-wise greedy NMS as one joint pass over class-offset boxes, so
     different classes never overlap (utils.py:194-220) — the Hopper kernel
     on a CUDA tensor, the plain version on a CPU tensor;
  4. fixed-size output: top max_dets survivors per image with a validity
     mask.

Output rows are [x1, y1, x2, y2, obj_conf, cls_conf, cls_idx] in input-image
pixels (utils.py:171-184).
"""

from __future__ import annotations

import warnings
from typing import Tuple

import torch

from yolov4_tpu_torch.ops.boxes import cxcywh_to_xyxy
from yolov4_tpu_torch.ops.nms import greedy_nms_mask
from yolov4_tpu_torch.ops.nms_cuda import greedy_nms_mask_cuda
from yolov4_tpu_torch.ops.replica import replica_max

NMS_ENGINES = ("auto", "plain")


def _rank_in_class(cls_idx: torch.Tensor, scores: torch.Tensor,
                   keep: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Within-class descending-score rank of each kept row.

    cls_idx/scores/keep: [B, K]; scores in [0, 1]. Returns [B, K] int32 —
    rank r means r kept same-class rows score at least as high (ties
    broken by candidate order, matching pycocotools' stable mergesort).
    Non-kept rows get rank K.
    """
    k = cls_idx.shape[-1]
    scores = torch.clamp(scores, 0.0, 1.0)
    # composite key: class ascending, descending score inside each class;
    # suppressed rows sort to the tail as class C+1
    skey = torch.where(keep, cls_idx.float() * 2.0 + (1.0 - scores),
                       torch.tensor(float(2 * num_classes + 3),
                                    device=scores.device))
    sorted_key, perm = torch.sort(skey, dim=-1, stable=True)
    sorted_cls = torch.floor(sorted_key * 0.5).to(torch.int32).contiguous()
    # start of each class run = searchsorted of the run values in themselves
    first = torch.searchsorted(sorted_cls, sorted_cls, side="left")
    pos = torch.arange(k, device=scores.device)[None, :]
    ranks_sorted = (pos - first).to(torch.int32)
    rank = torch.empty_like(ranks_sorted).scatter_(1, perm, ranks_sorted)
    return torch.where(keep, rank, torch.full_like(rank, k))


def postprocess(predictions: torch.Tensor, num_classes: int,
                conf_thre: float, nms_thre: float,
                pre_nms_topk: int = 2048,
                max_dets: int = 100,
                nms_engine: str = "auto",
                topk_approx: bool = False,
                cat_cap: int = 100,
                return_relevant_count: bool = False
                ) -> Tuple[torch.Tensor, ...]:
    """predictions: [B, N, 5+C] decoded model output (cxcywh + obj + cls).

    ``nms_engine``: "auto" runs the NMS kernel on a CUDA tensor (any K;
    the kernel masks the ragged edge) and the plain version on a CPU
    tensor; "plain" runs the plain version on any device (the kernel's
    yardstick). ``topk_approx`` selects TPU PartialReduce top-k in the JAX
    package; here it is accepted and ignored (the selection stays exact).

    ``cat_cap`` mirrors pycocotools' per-(image, category) maxDets
    truncation: when max_dets > cat_cap, kept rows whose within-class rank
    is >= cat_cap are dropped before the final top-max_dets selection
    (for max_dets <= cat_cap that is provably a no-op and is skipped).
    0 disables.

    Returns:
      detections: [B, max_dets, 7] = x1,y1,x2,y2,obj,cls_conf,cls_idx
        (score-sorted; invalid rows are zeros)
      valid: [B, max_dets] bool
      relevant_count: [B] int32, only when ``return_relevant_count`` —
        post-NMS rows that can matter to a cat_cap-style scorer.
    """
    if nms_engine not in NMS_ENGINES:
        raise ValueError(f"nms_engine must be one of {NMS_ENGINES}: "
                         f"{nms_engine!r}")
    if topk_approx:
        warnings.warn("TEST.APPROX_TOPK is a TPU PartialReduce option; the "
                      "port ignores it and selects exactly", stacklevel=2)
    predictions = predictions.float()
    b, n, _ = predictions.shape
    obj = predictions[..., 4]                                   # [B, N]
    cls_prob = predictions[..., 5:5 + num_classes]              # [B, N, C]

    k_box = min(pre_nms_topk, n)
    best_per_box = obj * cls_prob.amax(dim=-1)                  # [B, N]
    _, box_sel = torch.topk(best_per_box, k_box, dim=-1)        # [B, Kb]
    # one row gather: the 85-wide rows carry box, obj and classes together
    sel_rows = torch.gather(
        predictions, 1,
        box_sel[..., None].expand(-1, -1, predictions.shape[-1]))
    sel_boxes_kb = cxcywh_to_xyxy(sel_rows[..., :4])            # [B, Kb, 4]
    sel_obj_boxes = sel_rows[..., 4]                            # [B, Kb]
    sel_cls_boxes = sel_rows[..., 5:5 + num_classes]            # [B, Kb, C]

    pair_scores = sel_obj_boxes[..., None] * sel_cls_boxes      # [B, Kb, C]
    flat = pair_scores.reshape(b, k_box * num_classes)
    flat = torch.where(flat >= conf_thre, flat, torch.full_like(flat, -1.0))
    k = min(pre_nms_topk, k_box * num_classes)
    top_scores, top_idx = torch.topk(flat, k, dim=-1)           # [B, K] desc
    valid = top_scores >= conf_thre

    box_local = top_idx // num_classes                          # [B, K] in Kb
    cls_idx = top_idx % num_classes

    sel_boxes = torch.gather(
        sel_boxes_kb, 1, box_local[..., None].expand(-1, -1, 4))  # [B, K, 4]
    sel_obj = torch.gather(sel_obj_boxes, 1, box_local)
    sel_cls_conf = top_scores / torch.clamp(sel_obj, min=1e-16)

    # class-offset trick: disjoint coordinate islands per class. The span
    # covers the full coordinate RANGE: decoded boxes are unclipped, and a
    # negative-coordinate box must not hang into the previous class. It is
    # the whole batch's, over a mesh's replicas too (the JAX package's
    # program is partitioned and keeps it global), so that a row's
    # detections do not depend on how the batch was sharded.
    span = 2.0 * replica_max(sel_boxes.abs().amax()) + 1.0
    offset_boxes = sel_boxes + (cls_idx.float() * span)[..., None]
    if nms_engine == "plain":
        keep = greedy_nms_mask(offset_boxes, valid, nms_thre)
    else:
        keep = greedy_nms_mask_cuda(offset_boxes, valid, nms_thre)

    neg = torch.full_like(top_scores, -1.0)
    kept_scores = torch.where(keep, top_scores, neg)
    relevant = keep  # the NMS guarantees keep implies valid
    if cat_cap and (max_dets > cat_cap or return_relevant_count):
        rank = _rank_in_class(cls_idx, top_scores, relevant, num_classes)
        relevant = relevant & (rank < cat_cap)
        if max_dets > cat_cap:
            kept_scores = torch.where(relevant, kept_scores, neg)
    d = min(max_dets, k)
    final_scores, order = torch.topk(kept_scores, d, dim=-1)    # [B, D]
    final_valid = final_scores > 0.0

    def take(x):
        return torch.gather(x, 1, order)

    det = torch.cat([
        torch.gather(sel_boxes, 1, order[..., None].expand(-1, -1, 4)),
        take(sel_obj)[..., None],
        take(sel_cls_conf)[..., None],
        take(cls_idx.float())[..., None],
    ], dim=-1)
    det = torch.where(final_valid[..., None], det, torch.zeros_like(det))
    if return_relevant_count:
        return det, final_valid, relevant.sum(dim=-1, dtype=torch.int32)
    return det, final_valid
