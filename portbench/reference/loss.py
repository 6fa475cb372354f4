"""The YOLO loss and the classifier's smoothed cross-entropy in plain
PyTorch: a frozen copy of the program's plain loss (the reference's
yolo/model/yololoss.py:94-443, vectorized over a fixed [B, K, 5] label
tensor).

    loss = BCE(xy, weight=scale^2) + MSE(wh)/2 + BCE(obj) + BCE(cls)

summed over the three scales, reduction "sum"; BCE on probabilities with
the log clamped at -100 (torch.nn.BCELoss) and its backward
(p - t) / max(p (1 - p), 1e-12).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.model import ANCHOR_MASK, ANCHORS, STRIDES


class _BCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, p, t):
        ctx.save_for_backward(p, t)
        return -(t * torch.clamp(torch.log(p), min=-100.0)
                 + (1.0 - t) * torch.clamp(torch.log1p(-p), min=-100.0))

    @staticmethod
    def backward(ctx, g):
        p, t = ctx.saved_tensors
        return g * (p - t) / torch.clamp(p * (1.0 - p), min=1e-12), None


def _bce_sum(p, t, weight=None):
    e = _BCE.apply(p, t)
    return torch.sum(e if weight is None else e * weight)


def _iou_cxcywh(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[B, N, 4] x [B, K, 4] -> [B, N, K]."""
    a_tl, a_br = a[..., :2] - a[..., 2:] / 2, a[..., :2] + a[..., 2:] / 2
    b_tl, b_br = b[..., :2] - b[..., 2:] / 2, b[..., :2] + b[..., 2:] / 2
    tl = torch.maximum(a_tl[:, :, None], b_tl[:, None])
    br = torch.minimum(a_br[:, :, None], b_br[:, None])
    inter = torch.prod(br - tl, -1) * torch.prod((tl < br).float(), -1)
    union = (torch.prod(a[..., 2:], -1)[:, :, None]
             + torch.prod(b[..., 2:], -1)[:, None] - inter)
    return inter / torch.clamp(union, min=1e-16)


def _anchor_iou(wh: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    iw = torch.minimum(wh[..., None, 0], anchors[:, 0])
    ih = torch.minimum(wh[..., None, 1], anchors[:, 1])
    inter = torch.where((iw > 0) & (ih > 0), iw * ih, torch.zeros_like(iw))
    union = (wh[..., 0] * wh[..., 1])[..., None] + anchors.prod(-1) - inter
    return inter / torch.clamp(union, min=1e-16)


def yolo_loss(outputs: List[Dict], labels: torch.Tensor,
              n_classes: int = 80, ignore_thresh: float = 0.7
              ) -> torch.Tensor:
    """outputs: the train-mode model's three dicts; labels [B, K, 5] (cx,
    cy, w, h, cls) in input pixels, zero rows are padding."""
    total = 0.0
    anchors_np = np.asarray(ANCHORS, np.float32)
    for out in outputs:
        layer_no, output, pred = out["layer_no"], out["output"], out["pred"]
        b, na, f, _, _ = output.shape
        dev, dt = output.device, output.dtype
        stride = float(STRIDES[layer_no])
        mask = list(ANCHOR_MASK[layer_no])
        all_anc = torch.from_numpy(anchors_np / stride).to(dev)
        lay_anc = torch.from_numpy(anchors_np[mask] / stride).to(dev)
        lab = labels.to(dt)
        with torch.no_grad():
            valid = lab.sum(2) > 0
            truth = lab[..., :4] / stride
            ti = torch.clamp(truth[..., 0].long(), 0, f - 1)
            tj = torch.clamp(truth[..., 1].long(), 0, f - 1)
            best_all = torch.argmax(_anchor_iou(truth[..., 2:4], all_anc), -1)
            best = best_all % 3
            in_layer = torch.zeros_like(valid)
            for m in mask:
                in_layer |= best_all == m
            assign = valid & in_layer
            gt = torch.where(valid[..., None], truth, torch.zeros_like(truth))
            piou = _iou_cxcywh(pred.reshape(b, -1, 4), gt)
            piou = torch.where(valid[:, None], piou, torch.zeros_like(piou))
            obj_mask = (piou.max(-1).values.reshape(b, na, f, f)
                        <= ignore_thresh).to(dt)
            bi = torch.arange(b, device=dev)[:, None].expand_as(assign)
            ai = torch.where(assign, best, torch.full_like(best, na))
            ji = torch.where(assign, tj, torch.zeros_like(tj))
            ii = torch.where(assign, ti, torch.zeros_like(ti))
            index = (bi, ai, ji, ii)
            fx = truth[..., 0] - truth[..., 0].to(torch.int32).to(dt)
            fy = truth[..., 1] - truth[..., 1].to(torch.int32).to(dt)
            awh = lay_anc[best % na]
            tw = torch.log(truth[..., 2] / awh[..., 0] + 1e-16)
            th = torch.log(truth[..., 3] / awh[..., 1] + 1e-16)
            scale = torch.sqrt(2.0 - truth[..., 2] * truth[..., 3] / (f * f))
            ci = torch.clamp(lab[..., 4].long(), 0, n_classes - 1)
            cells = (b, na + 1, f, f)

            def scat(v):
                return torch.zeros(cells, dtype=dt, device=dev).index_put_(
                    index, v)[:, :na]

            ones = torch.ones_like(fx)
            obj_mask = torch.cat([obj_mask, torch.zeros_like(obj_mask[:, :1])],
                                 1).index_put_(index, ones)[:, :na]
            tmask = scat(ones)
            tscale = scat(scale)
            tcls = torch.zeros(cells + (n_classes,), dtype=dt, device=dev)
            tcls = tcls.index_put_(index + (ci,), ones)[:, :na]
            tcls = tcls * tmask[..., None]
            txy = torch.stack([scat(fx), scat(fy)], -1) * tmask[..., None]
            twh = (torch.stack([scat(tw), scat(th)], -1) * tmask[..., None]
                   * tscale[..., None])
        loss_obj = _bce_sum(output[..., 4] * obj_mask, tmask * obj_mask)
        loss_cls = _bce_sum(output[..., 5:] * tmask[..., None], tcls)
        loss_xy = _bce_sum(output[..., 0:2] * tmask[..., None], txy,
                           weight=(tscale * tscale)[..., None])
        out_wh = output[..., 2:4] * tmask[..., None] * tscale[..., None]
        loss_wh = torch.sum(torch.square(out_wh - twh)) / 2.0
        total = total + loss_xy + loss_wh + loss_obj + loss_cls
    return total


def smoothed_ce(logits: torch.Tensor, labels: torch.Tensor,
                smoothing: float = 0.1) -> torch.Tensor:
    """Mean cross-entropy against one-hot labels smoothed to
    (1 - s) one_hot + s / K."""
    logp = F.log_softmax(logits.float(), -1)
    k = logits.shape[-1]
    target = torch.full_like(logp, smoothing / k)
    target.scatter_(1, labels.long()[:, None], 1.0 - smoothing + smoothing / k)
    return -(target * logp).sum(-1).mean()
