"""The comparison that decides ``correct``: the numbers a run compares
with the plain reference. The limits are per cell, in
``portbench/limits/<cell>.json``, each set between the program's largest
reading over a dozen seeds and the least reading of the control (or, in
training, of a fault), on the card at the cell's own size
(portbench/readings.py).

Detection (each checked image's served detections, and the reference's
dense predictions and own post-NMS detections of that image):

* ``det_gap``: per image, the mean over its served detections of each
  one's gap to the nearest reference anchor, max(box error, |obj -
  obj_ref|, |cls_conf - cls_ref of the served class|), the box error
  being the largest coordinate difference over the reference box's
  longer side (at least one pixel); the largest over the images. An
  image's answer altered, or left out, lies far from every anchor.
* ``det_max``: the largest single detection's gap.
* ``miss_mean``: over every reference detection of the checked images,
  the mean gap to the nearest served detection of its class (1 where an
  image has none): detections the selection dropped.

Training (the first three steps of the object the window then drives):

* ``loss_gap``: the first step's |loss - loss_ref| / |loss_ref| (the
  later steps follow Adam's first update, which moves every element by
  about lr whatever the precision of its sign);
* ``grad_gap``: the first gradient as the optimizer got it (Adam's first
  moment after one step over 1 - beta1), by the worst leaf:
  | |g| - |g_ref| | / max(|g_ref|, the median leaf's |g_ref|);
* ``grad_med``: the same gap of the median leaf;
* ``delta_gap``: the parameters' change over the three steps, by the
  worst leaf, over the leaves whose reference gradient is at least a
  thousandth of the median leaf's (the others move by round-off alone).
"""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np
import torch

from portbench.reference.detect import cxcywh_to_xyxy

LEAF_FLOOR = 1e-3


def nearest_gaps(rows: torch.Tensor, pred: torch.Tensor,
                 num_classes: int) -> torch.Tensor:
    """[M]: each detection's gap to the nearest of N candidate rows of the
    same image: max(box error, |obj - obj'|, |cls_conf - the candidate's
    score for the detection's class|), least over the candidates. ``rows``
    [M, 7] detections, ``pred`` [N, 5+C] decoded rows (cx, cy, w, h, obj,
    classes)."""
    if not rows.shape[0]:
        return rows.new_zeros(0)
    gap = box_error(rows[:, :4], pred[:, :4])
    cls = pred[:, 5:5 + num_classes].t()[rows[:, 6].long()]
    gap = torch.maximum(gap, (rows[:, 4:5] - pred[None, :, 4]).abs())
    gap = torch.maximum(gap, (rows[:, 5:6] - cls).abs())
    return gap.min(1).values


def _as_pred(det: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Detections [M, 7] as decoded rows [M, 5+C]: cx, cy, w, h, obj and
    a one-hot-scaled class score."""
    box = torch.cat([(det[:, :2] + det[:, 2:4]) / 2, det[:, 2:4] - det[:, :2]],
                    -1)
    cls = torch.zeros(det.shape[0], num_classes, device=det.device)
    cls.scatter_(1, det[:, 6:7].long(), det[:, 5:6])
    return torch.cat([box, det[:, 4:5], cls], -1)


@torch.no_grad()
def detection_gaps(det: torch.Tensor, valid: torch.Tensor,
                   ref_pred: torch.Tensor, ref_det: torch.Tensor,
                   ref_valid: torch.Tensor, num_classes: int) -> Dict:
    """One batch's numbers, as lists: per image ``det_gap`` and
    ``det_max``; the sums ``miss_sum`` / ``miss_n`` of the gaps of the
    reference's detections to the served ones (``pooled`` takes their
    mean over all images)."""
    out = {k: [] for k in ("det_gap", "det_max", "miss_sum", "miss_n")}
    for i in range(det.shape[0]):
        rows = det[i][valid[i]]
        near = nearest_gaps(rows, ref_pred[i], num_classes)
        ref_rows = ref_det[i][ref_valid[i]]
        if rows.shape[0]:
            miss = nearest_gaps(ref_rows, _as_pred(rows, num_classes),
                                num_classes)
        else:
            miss = torch.ones(ref_rows.shape[0], device=det.device)
        out["det_gap"].append(float(near.mean()) if near.numel() else 0.0)
        out["det_max"].append(float(near.max()) if near.numel() else 0.0)
        out["miss_sum"].append(float(miss.sum()))
        out["miss_n"].append(miss.numel())
    return out


def pooled(per_image: Dict[str, list]) -> Dict[str, list]:
    """The per-image numbers, and ``miss_mean`` over every checked
    reference detection as a one-item list."""
    out = {k: per_image[k] for k in ("det_gap", "det_max")}
    out["miss_mean"] = [sum(per_image["miss_sum"])
                        / max(sum(per_image["miss_n"]), 1)]
    return out


def box_error(xyxy: torch.Tensor, ref_cxcywh: torch.Tensor) -> torch.Tensor:
    """[M, N]: the largest coordinate difference between M served boxes
    and N reference boxes, over the reference box's longer side (at least
    one pixel)."""
    ref = cxcywh_to_xyxy(ref_cxcywh)
    diff = (xyxy[:, None, :] - ref[None, :, :]).abs().amax(-1)
    side = torch.clamp(ref_cxcywh[:, 2:4].amax(-1), min=1.0)
    return diff / side[None, :]


def _gap(p: float, r: float, scale: float) -> float:
    return abs(p - r) / max(scale, 1e-30)


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
               keys) -> Dict[str, float]:
    """| |p| - |r| | / max(|r|, the median leaf's |r|), by leaf."""
    med = float(np.median([ref[k] for k in keys]))
    return {k: _gap(prog[k], ref[k], max(ref[k], med)) for k in keys}


def leaf_gaps(prog: Dict, ref: Dict):
    """(the first gradient's gap by leaf, the change's gap by leaf over the
    leaves the reference moves, the loss gap of each step)."""
    gref = ref["grad"]
    med = float(np.median(list(gref.values())))
    grad = _leaf_gaps(prog["grad"], gref, list(gref))
    moved = [k for k, v in gref.items() if v >= LEAF_FLOOR * med]
    delta = _leaf_gaps(prog["delta"], ref["delta"], moved)
    steps = [_gap(p, r, abs(r)) for p, r in zip(prog["loss"], ref["loss"])]
    return grad, delta, steps


def train_gaps(prog: Dict, ref: Dict) -> Dict[str, float]:
    """``prog`` and ``ref``: {"loss": [per step], "grad": {leaf: norm of
    the first gradient}, "delta": {leaf: norm of the change}}."""
    grad, delta, steps = leaf_gaps(prog, ref)
    return {"loss_gap": steps[0], "grad_gap": max(grad.values()),
            "grad_med": float(np.median(list(grad.values()))),
            "delta_gap": max(delta.values())}


def worst_leaves(prog: Dict, ref: Dict, n: int = 3) -> Dict:
    """The leaves of the largest gradient and change gaps, and the loss
    gap of each step: what a reading's look needs."""
    grad, delta, steps = leaf_gaps(prog, ref)
    return {"loss_by_step": steps,
            "grad_worst": sorted(grad.items(), key=lambda kv: -kv[1])[:n],
            "delta_worst": sorted(delta.items(), key=lambda kv: -kv[1])[:n],
            "left_out": len(grad) - len(delta)}


def load_limits(root: str, workload: str) -> Dict[str, float]:
    """The cell's limits, ``portbench/limits/<workload>.json``: {number:
    {"limit": x, ...}}."""
    path = os.path.join(root, "portbench", "limits", f"{workload}.json")
    with open(path) as f:
        return {k: float(v["limit"]) for k, v in json.load(f).items()}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]
            ) -> Dict[str, Dict[str, float]]:
    """{name: {"value", "limit"}} for every number the cell's limits
    name; a limit whose number was not read is an error, not a pass."""
    missing = set(limits) - set(numbers)
    if missing:
        raise KeyError(f"no reading of {sorted(missing)}")
    return {k: {"value": float(numbers[k]), "limit": limits[k]}
            for k in sorted(limits)}


def is_correct(checks: Dict[str, Dict[str, float]]) -> bool:
    return all(np.isfinite(c["value"]) and c["value"] <= c["limit"]
               for c in checks.values())
