"""Greedy NMS over score-sorted candidates: the plain PyTorch version.

This is the reference the Hopper kernel (ops/nms_cuda.py) is held against,
and the path every CPU tensor takes. It solves the greedy recurrence

    keep[i] = valid[i]  and  no j < i with keep[j] and IoU[j, i] >= t

block by block: suppression from already-final earlier blocks is one
masked any-reduction, and only the [B, block, block] within-block
recurrence iterates, by Jacobi rounds from keep = base to the fixpoint.
The greedy result is the unique solution, so any correct solver gives the
same mask bit for bit (JAX package: ops/nms.py).
"""

from __future__ import annotations

import torch

from yolov4_tpu_torch.ops.boxes import iou_pairwise_safe


def _jacobi_fixpoint(pair: torch.Tensor, base: torch.Tensor) -> torch.Tensor:
    """Solve keep[i] = base[i] & no j<i with keep[j] & pair[j,i] by Jacobi
    iteration from keep = base; stops at the fixpoint, reached in
    suppression-chain-depth rounds."""
    keep = base
    while True:
        hit = (pair & keep[:, :, None]).any(dim=1)
        new_keep = base & ~hit
        if torch.equal(new_keep, keep):
            return keep
        keep = new_keep


def greedy_nms_mask(boxes_xyxy: torch.Tensor, valid: torch.Tensor,
                    iou_thresh: float, block: int = 256) -> torch.Tensor:
    """Greedy suppression over score-sorted candidates.

    Args:
      boxes_xyxy: [B, K, 4] float32, sorted by descending score along K.
      valid: [B, K] bool — below-threshold / padding slots are False.
      iou_thresh: suppress at IoU >= thresh (reference utils.py:77),
        compared in float32.
      block: rows finalized per step.

    Returns:
      keep: [B, K] bool.
    """
    k = boxes_xyxy.shape[-2]
    thresh = torch.tensor(iou_thresh, dtype=torch.float32,
                          device=boxes_xyxy.device)
    iou = iou_pairwise_safe(boxes_xyxy, boxes_xyxy)  # [B, K, K]
    idx = torch.arange(k, device=boxes_xyxy.device)
    # pair[b, j, i]: j would suppress i if j is kept (strictly upper-tri)
    pair = ((iou >= thresh) & (idx[:, None] < idx[None, :])
            & valid[:, :, None])
    del iou

    if k <= block:
        return _jacobi_fixpoint(pair, valid)

    parts = []
    for r0 in range(0, k, block):
        t = min(block, k - r0)
        base = valid[:, r0:r0 + t]
        if r0:
            # suppression by kept boxes in already-final earlier blocks
            keep_prev = torch.cat(parts, dim=1)  # [B, r0]
            ext = (pair[:, :r0, r0:r0 + t] & keep_prev[:, :, None]).any(dim=1)
            base = base & ~ext
        parts.append(_jacobi_fixpoint(pair[:, r0:r0 + t, r0:r0 + t], base))
    return torch.cat(parts, dim=1)
