"""COCO validation loop (reference yolo/engine/build.py:111-190), the port's
copy of the JAX package's engine/evaluator.py.

Batched inference on the device (the reference evaluates at batch 1
through CPU NMS); the host unmaps boxes to source-image coordinates and
feeds the first-party COCO evaluator. Under data parallelism every rank
evaluates its shard of val2017; the rows are gathered over the host group,
rank 0 scores them, and every rank returns the same two stats.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as tdist

from yolov4_tpu_torch.eval.cocoeval import COCOEvaluator
from yolov4_tpu_torch.ops.boxes import unmap_to_source_tlwh
from yolov4_tpu_torch.parallel import dist as dist_lib
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


def _dedup_wrap_padding(per_process: List[Tuple[List[Dict], List[int]]],
                        ) -> Tuple[List[Dict], List[int]]:
    """Drop wrap-padded duplicate images from gathered per-process results.

    The loader pads the index list to a multiple of the process count by
    wrapping (data/pipeline.py ``_local_indices``), so when the dataset
    size is not divisible by it the same image is evaluated on more than
    one process. Scoring it twice would count its ground truths twice and
    its duplicate detections as false positives. The copies are identical
    (same index, same deterministic eval transform): keep the first
    process's copy of each image id and drop the rest."""
    rows_out: List[Dict] = []
    ids_out: List[int] = []
    seen: set = set()
    for p_rows, p_ids in per_process:
        dup = {i for i in p_ids if i in seen}
        ids_out.extend(i for i in p_ids if i not in seen)
        rows_out.extend(r for r in p_rows if r["image_id"] not in dup)
        seen.update(p_ids)
    return rows_out, ids_out


def _all_gather(t: torch.Tensor, group) -> List[torch.Tensor]:
    out = [torch.empty_like(t) for _ in range(tdist.get_world_size(group))]
    tdist.all_gather(out, t, group=group)
    return out


def _gather_rows(rows: List[Dict], ids: List[int],
                 group) -> Tuple[List[Dict], List[int]]:
    """All-gather every process's detection rows and image ids over the
    (gloo) ``group``, in rank order, with wrap-padded duplicate images
    dropped (_dedup_wrap_padding). Rows travel as float64 records
    (image_id, category_id, x, y, w, h, score) padded to the largest
    per-process count, which the gather needs equal."""
    packed = torch.from_numpy(np.array(
        [[r["image_id"], r["category_id"], *r["bbox"], r["score"]]
         for r in rows], np.float64).reshape(-1, 7))
    id_arr = torch.tensor(ids, dtype=torch.float64)
    counts = torch.stack(_all_gather(
        torch.tensor([len(rows), len(ids)], dtype=torch.int64), group))
    max_rows, max_ids = (int(v) for v in counts.max(0).values)
    packed = torch.nn.functional.pad(packed, (0, 0, 0, max_rows - len(rows)))
    id_arr = torch.nn.functional.pad(id_arr, (0, max_ids - len(ids)))
    all_rows = _all_gather(packed, group)
    all_ids = _all_gather(id_arr, group)
    per_process = []
    for p, (n_rows, n_ids) in enumerate(counts.tolist()):
        p_rows = [{"image_id": int(r[0]), "category_id": int(r[1]),
                   "bbox": [float(v) for v in r[2:6]], "score": float(r[6])}
                  for r in all_rows[p][:n_rows].tolist()]
        per_process.append((p_rows, [int(v) for v in
                                     all_ids[p][:n_ids].tolist()]))
    return _dedup_wrap_padding(per_process)


def validate(val_loader, predictor, conf_threshold: Optional[float] = None,
             nms_threshold: Optional[float] = None,
             verbose: bool = True) -> Tuple[float, float]:
    """Run COCO eval; returns (AP[.50:.95], AP50) like the reference.
    With several ranks, every rank calls it on its shard of the loader and
    gets the stats of the whole set.

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
        out, infos, mask = pending
        det, valid, *nrel = predictor.fetch_local(out)
        if nrel:
            nrel = nrel[0][: len(mask)][np.asarray(mask, bool)]
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
        inflight.append((out, target["img_info"], target["batch_mask"]))
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

    group = dist_lib.host_group()
    multi = dist_lib.world_size() > 1
    if multi:
        rows, ids = _gather_rows(rows, ids, group)
    stats01 = torch.zeros(2, dtype=torch.float64)
    if rows and dist_lib.is_primary():
        evaluator = COCOEvaluator(dataset.coco, img_ids=ids,
                                  cat_ids=dataset.class_ids)
        evaluator.add_detections(rows)
        stats = evaluator.evaluate(verbose=verbose)
        stats01 = torch.tensor([float(stats[0]), float(stats[1])],
                               dtype=torch.float64)
    if multi:
        # rank 0 scored; the others wait for its stats, then all leave
        # together (the JAX package's sync_global_devices("validate_done"))
        tdist.broadcast(stats01, tdist.get_global_rank(group, 0),
                        group=group)
        dist_lib.lockstep("validate_done")
    return float(stats01[0]), float(stats01[1])
