"""COCO validation loop (reference yolo/engine/build.py:111-190), the port's
copy of the JAX package's engine/evaluator.py for one process.

Batched inference on the device (the reference evaluates at batch 1
through CPU NMS); the host unmaps boxes to source-image coordinates and
feeds the first-party COCO evaluator. Gathering rows from several
processes waits for the data-parallel slice.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np

from yolov4_tpu_torch.eval.cocoeval import COCOEvaluator
from yolov4_tpu_torch.ops.boxes import unmap_to_source_tlwh
from yolov4_tpu_torch.utils.logging import get_logger
from yolov4_tpu_torch.utils.metrics import AverageMeter

logger = get_logger(__name__)

# batches dispatched ahead of the one whose detections the host unmaps
IN_FLIGHT = 3


def detections_to_coco(det: np.ndarray, valid: np.ndarray, img_info: np.ndarray,
                       class_ids: List[int]) -> List[Dict]:
    """One image's fixed-shape detections -> COCO result rows.

    det rows are x1,y1,x2,y2,obj,cls_conf,cls in model-input pixels; boxes
    unmap through the resize to source tlwh (reference
    engine/build.py:146-164, utils.py:281-309)."""
    src_h, src_w, dst_h, dst_w = (float(v) for v in img_info[:4])
    # letterbox geometry: img_info carries 6 geometry fields + img_id +
    # index (offsets 0 in stretch mode); older 4+2 layouts have none
    off = ((float(img_info[4]), float(img_info[5]))
           if len(img_info) >= 8 else (0.0, 0.0))
    img_id = int(img_info[-2])
    d = det[valid]
    if not d.shape[0]:
        return []
    bboxes = np.asarray(unmap_to_source_tlwh(
        d[:, :4], (src_h, src_w), (dst_h, dst_w), offset_xy=off), np.float64)
    return [{
        "image_id": img_id,
        "category_id": class_ids[int(r[6])],
        "bbox": [float(v) for v in bboxes[i]],
        "score": float(r[4] * r[5]),
    } for i, r in enumerate(d)]


def validate(val_loader, predictor, conf_threshold: Optional[float] = None,
             nms_threshold: Optional[float] = None,
             verbose: bool = True) -> Tuple[float, float]:
    """Run COCO eval; returns (AP[.50:.95], AP50) like the reference.

    Threshold overrides are call-scoped (restored on exit): an AP sweep at
    conf 0.001 must not leave a reused predictor flooding later detection
    calls with low-confidence rows."""
    saved = (predictor.conf_thre, predictor.nms_thre)
    if conf_threshold is not None:
        predictor.conf_thre = conf_threshold
    if nms_threshold is not None:
        predictor.nms_thre = nms_threshold
    try:
        return _validate(val_loader, predictor, verbose)
    finally:
        predictor.conf_thre, predictor.nms_thre = saved


def _validate(val_loader, predictor, verbose: bool) -> Tuple[float, float]:
    dataset = val_loader.dataset
    batch_time = AverageMeter()
    rows: List[Dict] = []
    ids: List[int] = []
    # when the predictor counts scoring-relevant rows (max_dets deeper than
    # the per-(image,category) cap), prove the fixed-size output lossless:
    # any image with relevant_count > max_dets lost protocol rows
    overflow = {"images": 0, "max_relevant": 0, "counted": False}

    def consume(pending):
        det_dev, valid_dev, nrel_dev, infos, mask = pending
        det = det_dev.cpu().numpy()
        valid = valid_dev.cpu().numpy()
        if nrel_dev is not None:
            nrel = nrel_dev.cpu().numpy()[: len(mask)][np.asarray(mask, bool)]
            overflow["counted"] = True
            if nrel.size:
                overflow["images"] += int((nrel > det.shape[1]).sum())
                overflow["max_relevant"] = max(overflow["max_relevant"],
                                               int(nrel.max()))
        for i in range(len(mask)):
            if not mask[i]:
                continue
            ids.append(int(infos[i][-2]))
            rows.extend(detections_to_coco(det[i], valid[i], infos[i],
                                           dataset.class_ids))

    # pipelined: a few batches stay queued on the device while the host
    # unmaps an earlier one's detections
    end = time.time()
    n_batches = len(val_loader)
    inflight: deque = deque()
    for bi, (imgs, target) in enumerate(val_loader):
        out = predictor.dispatch(imgs)
        inflight.append((out[0], out[1], out[2] if len(out) > 2 else None,
                         target["img_info"], target["batch_mask"]))
        if len(inflight) > IN_FLIGHT:
            consume(inflight.popleft())
        batch_time.update(time.time() - end)
        end = time.time()
        if verbose and (bi + 1) % 50 == 0:
            ips = imgs.shape[0] / max(batch_time.avg, 1e-9)
            logger.info(f"eval [{bi + 1}/{n_batches}] "
                        f"{batch_time.val:.3f}s/batch ({ips:.1f} img/s)")
    while inflight:
        consume(inflight.popleft())

    if verbose:
        logger.info(f"eval done: {len(ids)} images, {len(rows)} detections, "
                    f"avg {batch_time.avg:.3f}s/batch")
    if overflow["counted"]:
        if overflow["images"]:
            logger.warning(
                f"max_dets overflow on {overflow['images']} images (up to "
                f"{overflow['max_relevant']} scoring-relevant rows vs "
                f"max_dets {predictor.max_dets}): the fixed-size output "
                f"dropped rows pycocotools' per-(image,category) cap would "
                f"have scored — raise TEST.MAX_DETS")
        elif verbose:
            logger.info(
                f"max_dets lossless: <= {overflow['max_relevant']} "
                f"scoring-relevant rows/image (cap {predictor.max_dets})")

    if not rows:
        return 0.0, 0.0
    evaluator = COCOEvaluator(dataset.coco, img_ids=ids,
                              cat_ids=dataset.class_ids)
    evaluator.add_detections(rows)
    stats = evaluator.evaluate(verbose=verbose)
    return float(stats[0]), float(stats[1])
