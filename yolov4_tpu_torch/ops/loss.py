"""YOLO loss with vectorized target assignment: the port's copy of the JAX
package's ops/loss.py.

Numerically the reference YOLOLoss (yolo/model/yololoss.py:94-443), a
YOLOv3-style sum-reduction loss:

    loss = BCE(xy, weight=tgt_scale^2) + MSE(wh)/2 + BCE(obj) + BCE(cls)

summed over the three scales. The reference's per-image / per-ground-truth
loops (yololoss.py:222-369) become indexed writes over the fixed
[B, K=MAX_NUM_LABELS] label tensor, with no host synchronisation:

  * valid labels = rows whose 5 fields sum > 0 (yololoss.py:219);
  * best anchor over all 9 by IoU of (0,0,w,h) boxes, ``best_n_all % 3``
    intra-layer anchor index (yololoss.py:249-257);
  * layer ownership via anchor-mask membership (yololoss.py:264-265);
  * ignore mask: predictions with IoU > ignore_thresh against ANY valid
    ground truth leave the noobj loss, then assigned cells are re-enabled
    (yololoss.py:276-330);
  * tgt_scale = sqrt(2 - w*h/f^2), wh target log(gt/anchor + 1e-16)
    (yololoss.py:337,362-365);
  * BCE on probabilities with torch's log clamp at -100, reduction='sum'.

Rows that are not assigned write into one extra anchor slot that is cut
off afterwards: the JAX package's out-of-range scatter with
``mode="drop"``. When two ground truths land on the same (anchor, cell),
the box fields keep an unspecified one of them, as in the JAX package
(its docstring); class one-hots keep both.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from yolov4_tpu_torch.models.decode import STRIDES, at_least_f32
from yolov4_tpu_torch.ops.boxes import (iou_pairwise_safe,
                                        iou_variant_elementwise)

_LOG_CLAMP = -100.0  # torch.nn.BCELoss clamps log values at -100
BOX_LOSSES = ("mse", "iou", "giou", "diou", "ciou")


class _BCEElem(torch.autograd.Function):
    """Elementwise BCE on probabilities with torch.nn.BCELoss semantics:
    forward log values clamped at -100; backward (p - t) / max(p(1-p),
    1e-12) (ATen binary_cross_entropy_backward). Autograd through the
    clamped logs would give 0 * inf = NaN at exact p = 0 or 1, which
    masked cells hit."""

    @staticmethod
    def forward(ctx, p, t):
        log_p = torch.clamp(torch.log(p), min=_LOG_CLAMP)
        log_1p = torch.clamp(torch.log1p(-p), min=_LOG_CLAMP)
        ctx.save_for_backward(p, t)
        return -(t * log_p + (1.0 - t) * log_1p)

    @staticmethod
    def backward(ctx, g):
        p, t = ctx.saved_tensors
        dp = g * (p - t) / torch.clamp(p * (1.0 - p), min=1e-12)
        dt = None
        if ctx.needs_input_grad[1]:
            log_p = torch.clamp(torch.log(p), min=_LOG_CLAMP)
            log_1p = torch.clamp(torch.log1p(-p), min=_LOG_CLAMP)
            dt = g * (log_1p - log_p)
        return dp, dt


def bce_sum(p: torch.Tensor, t: torch.Tensor,
            weight: torch.Tensor = None) -> torch.Tensor:
    """Binary cross entropy on probabilities, reduction='sum'."""
    per_elem = _BCEElem.apply(p, t)
    if weight is not None:
        per_elem = per_elem * weight
    return torch.sum(per_elem)


def _anchor_iou_wh(gt_wh: torch.Tensor, anchors_wh: torch.Tensor):
    """IoU of (0,0,w,h) boxes against anchor (0,0,aw,ah) boxes (reference
    yololoss.py:146-150, 240-249). gt_wh [B, K, 2], anchors [9, 2] ->
    [B, K, 9]."""
    inter_w = torch.minimum(gt_wh[..., None, 0], anchors_wh[:, 0])
    inter_h = torch.minimum(gt_wh[..., None, 1], anchors_wh[:, 1])
    valid = (inter_w > 0) & (inter_h > 0)
    inter = torch.where(valid, inter_w * inter_h, torch.zeros_like(inter_w))
    area_gt = gt_wh[..., 0] * gt_wh[..., 1]
    area_anchor = anchors_wh[:, 0] * anchors_wh[:, 1]
    union = area_gt[..., None] + area_anchor - inter
    return inter / torch.clamp(union, min=1e-16)


class YOLOLoss:
    """``loss = YOLOLoss(cfg['MODEL'], ignore_thresh)(outputs, targets)``
    (reference model/build.py:31, yololoss.py:373).

    ``outputs`` is the train-mode model output (one dict per scale with
    ``layer_no``, ``output`` [B, A, f, f, 5+C] with raw wh and ``pred``
    [B, A, f, f, 4] decoded grid-unit boxes); ``targets['padded_labels']``
    is [B, K, 5] (cx, cy, w, h, cls) in input pixels.

    ``box_loss`` (CRITERION.BOX_LOSS): "mse" is the reference's weighted
    BCE(xy) + MSE(wh)/2; "iou" | "giou" | "diou" | "ciou" regress
    sum(tgt_mask * tgt_scale^2 * (1 - IoUv(pred, gt))) on the decoded
    boxes instead.
    """

    def __init__(self, model_cfg: Dict, ignore_thresh: float = 0.7,
                 box_loss: str = "mse"):
        self.anchors = np.asarray(model_cfg["ANCHORS"], dtype=np.float32)
        self.anchor_mask = [list(m) for m in model_cfg["ANCHOR_MASK"]]
        self.n_classes = int(model_cfg["N_CLASSES"])
        self.ignore_thresh = float(ignore_thresh)
        if box_loss not in BOX_LOSSES:
            raise ValueError(
                f"CRITERION.BOX_LOSS must be one of mse/iou/giou/diou/ciou: "
                f"{box_loss!r}")
        self.box_loss = box_loss

    def __call__(self, outputs: List[Dict], targets: Dict) -> torch.Tensor:
        labels = targets["padded_labels"]
        total = None
        for out in outputs:
            layer = self._layer_loss(out["layer_no"], out["output"],
                                     out["pred"], labels)
            total = layer if total is None else total + layer
        return total

    def _layer_loss(self, layer_no: int, output: torch.Tensor,
                    pred: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        output = at_least_f32(output)
        pred = at_least_f32(pred)
        labels = labels.to(output.dtype)
        dt, dev = output.dtype, output.device
        b, n_anchors, fsize, _, _ = output.shape
        stride = float(STRIDES[layer_no])
        mask = self.anchor_mask[layer_no]
        anchors_all = torch.from_numpy(self.anchors / stride).to(dev, dt)
        layer_anchors = torch.from_numpy(
            self.anchors[np.asarray(mask)] / stride).to(dev, dt)

        with torch.no_grad():
            valid = labels.sum(dim=2) > 0                               # [B, K]
            truth = labels[..., :4] / stride                            # [B, K, 4]
            truth_i = torch.clamp(truth[..., 0].to(torch.int64), 0, fsize - 1)
            truth_j = torch.clamp(truth[..., 1].to(torch.int64), 0, fsize - 1)

            best_n_all = torch.argmax(
                _anchor_iou_wh(truth[..., 2:4], anchors_all), dim=-1)
            best_n = best_n_all % 3
            in_layer = torch.zeros_like(valid)
            for m in mask:
                in_layer = in_layer | (best_n_all == m)
            assign = valid & in_layer

            # ignore mask: best IoU of each prediction over the valid truths
            gt_boxes = torch.where(valid[..., None], truth,
                                   torch.zeros_like(truth))
            pred_iou = iou_pairwise_safe(pred.reshape(b, -1, 4), gt_boxes,
                                         eps=1e-16, fmt="cxcywh")
            pred_iou = torch.where(valid[:, None, :], pred_iou,
                                   torch.zeros_like(pred_iou))
            pred_best = pred_iou.max(dim=-1).values.reshape(
                b, n_anchors, fsize, fsize)
            obj_mask = (pred_best <= self.ignore_thresh).to(dt)

            # assigned rows write to (b, anchor, j, i); the others to the
            # extra anchor slot n_anchors, cut off below
            batch_idx = torch.arange(b, device=dev)[:, None].expand_as(assign)
            a_idx = torch.where(assign, best_n, torch.full_like(best_n,
                                                                n_anchors))
            j_idx = torch.where(assign, truth_j, torch.zeros_like(truth_j))
            i_idx = torch.where(assign, truth_i, torch.zeros_like(truth_i))
            index = (batch_idx, a_idx, j_idx, i_idx)

            frac_x = truth[..., 0] - truth[..., 0].to(torch.int32).to(dt)
            frac_y = truth[..., 1] - truth[..., 1].to(torch.int32).to(dt)
            anchor_wh = layer_anchors[best_n % n_anchors]               # [B, K, 2]
            tw = torch.log(truth[..., 2] / anchor_wh[..., 0] + 1e-16)
            th = torch.log(truth[..., 3] / anchor_wh[..., 1] + 1e-16)
            scale = torch.sqrt(2.0 - truth[..., 2] * truth[..., 3]
                               / (fsize * fsize))
            cls_idx = torch.clamp(labels[..., 4].to(torch.int64), 0,
                                  self.n_classes - 1)

            cells = (b, n_anchors + 1, fsize, fsize)

            def scat(values):
                out = torch.zeros(cells, dtype=dt, device=dev)
                return out.index_put_(index, values)[:, :n_anchors]

            ones = torch.ones_like(frac_x)
            obj_mask = torch.cat([obj_mask, torch.zeros_like(obj_mask[:, :1])],
                                 dim=1).index_put_(index, ones)[:, :n_anchors]
            tgt_mask = scat(ones)
            tgt_scale = scat(scale)
            t_cls = torch.zeros(cells + (self.n_classes,), dtype=dt,
                                device=dev)
            t_cls = t_cls.index_put_(index + (cls_idx,), ones)[:, :n_anchors]
            t_obj = tgt_mask * obj_mask
            t_cls = t_cls * tgt_mask[..., None]

        out_obj = output[..., 4] * obj_mask
        out_cls = output[..., 5:] * tgt_mask[..., None]
        loss_obj = bce_sum(out_obj, t_obj)
        loss_cls = bce_sum(out_cls, t_cls)

        if self.box_loss != "mse":
            with torch.no_grad():
                t_box = torch.stack([scat(truth[..., c]) for c in range(4)],
                                    dim=-1)
            iou_v = iou_variant_elementwise(pred, t_box, kind=self.box_loss)
            loss_box = torch.sum(tgt_mask * tgt_scale * tgt_scale
                                 * (1.0 - iou_v))
            return loss_box + loss_obj + loss_cls

        with torch.no_grad():
            t_xy = torch.stack([scat(frac_x), scat(frac_y)], dim=-1) \
                * tgt_mask[..., None]
            t_wh = torch.stack([scat(tw), scat(th)], dim=-1) \
                * tgt_mask[..., None] * tgt_scale[..., None]
        out_xy = output[..., 0:2] * tgt_mask[..., None]
        out_wh = output[..., 2:4] * tgt_mask[..., None] * tgt_scale[..., None]
        weight_xy = (tgt_scale * tgt_scale)[..., None]
        loss_xy = bce_sum(out_xy, t_xy, weight=weight_xy)
        loss_wh = torch.sum(torch.square(out_wh - t_wh)) / 2.0
        return loss_xy + loss_wh + loss_obj + loss_cls


def build_criterion(cfg: Dict) -> YOLOLoss:
    """reference model/build.py:31; CRITERION.BOX_LOSS selects the opt-in
    IoU-variant regression ("mse", the default, is the reference's)."""
    if cfg["CRITERION"]["TYPE"] != "YOLOLoss":
        raise ValueError(f"unsupported CRITERION.TYPE "
                         f"{cfg['CRITERION']['TYPE']!r}")
    return YOLOLoss(cfg["MODEL"],
                    ignore_thresh=cfg["CRITERION"]["IGNORE_THRESH"],
                    box_loss=cfg["CRITERION"].get("BOX_LOSS", "mse"))
