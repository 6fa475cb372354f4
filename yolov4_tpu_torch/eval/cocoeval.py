"""COCO detection mAP evaluation (first-party COCOeval).

The port's copy of the JAX package's eval/cocoeval.py: the full COCOeval
bbox protocol of pycocotools.cocoeval.COCOeval, with the standard
12-number summary (AP/AP50/AP75/AP-s/m/l, AR@1/10/100, AR-s/m/l):

  * IoU thresholds 0.50:0.05:0.95, 101-point recall interpolation,
  * greedy per-detection matching in score order against the best
    still-available gt (crowd gts match many detections; IoU vs crowd is
    intersection over detection area),
  * gt ignore = iscrowd or area outside the range; ignored gts sort last
    and matches to them don't count as TP or FP,
  * unmatched detections outside the area range are ignored,
  * stable mergesort score ordering for determinism.

The (img, cat) IoU matrix is computed once and reused across the four
area ranges; the greedy matching runs in numpy, batched over all images of
one (category, area range) (the JAX package's native C matcher is host
code the port does not carry); accumulation is vectorized over IoU
thresholds. Detections are accumulated in memory.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
MAX_DETS = (1, 10, 100)
AREA_RNG = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}
AREA_ORDER = ("all", "small", "medium", "large")


def _iou_tlwh(dts: np.ndarray, gts: np.ndarray, iscrowd: np.ndarray) -> np.ndarray:
    """pycocotools maskUtils.iou for tlwh boxes: crowd gts use union=dt area."""
    if len(dts) == 0 or len(gts) == 0:
        return np.zeros((len(dts), len(gts)))
    dx1, dy1 = dts[:, 0], dts[:, 1]
    dx2, dy2 = dts[:, 0] + dts[:, 2], dts[:, 1] + dts[:, 3]
    gx1, gy1 = gts[:, 0], gts[:, 1]
    gx2, gy2 = gts[:, 0] + gts[:, 2], gts[:, 1] + gts[:, 3]

    iw = np.minimum(dx2[:, None], gx2[None, :]) - np.maximum(dx1[:, None], gx1[None, :])
    ih = np.minimum(dy2[:, None], gy2[None, :]) - np.maximum(dy1[:, None], gy1[None, :])
    inter = np.clip(iw, 0, None) * np.clip(ih, 0, None)
    area_d = (dts[:, 2] * dts[:, 3])[:, None]
    area_g = (gts[:, 2] * gts[:, 3])[None, :]
    union = np.where(iscrowd[None, :].astype(bool), area_d,
                     area_d + area_g - inter)
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def _match_batch(ious_flat, g_ig, iscrowd, d_out, nd, ng):
    """Greedy matching of every image of one (category, area range) at
    every IoU threshold, the per-gt scan vectorized (two-phase: non-ignored
    candidates, then ignored — equivalent to pycocotools' sorted scan with
    break-at-first-ignored). Returns (matched, ignored) [T, total dts]."""
    t_count = len(IOU_THRS)
    total_d = int(nd.sum())
    matched = np.zeros((t_count, total_d), bool)
    ignored = np.zeros((t_count, total_d), bool)
    ioff = goff = doff = 0
    for i in range(len(nd)):
        n_d, n_g = int(nd[i]), int(ng[i])
        if n_d == 0:
            ioff += n_d * n_g
            goff += n_g
            continue
        dout = d_out[doff:doff + n_d].astype(bool)
        if n_g == 0:
            ignored[:, doff:doff + n_d] = dout[None, :]
            doff += n_d
            continue
        ious = ious_flat[ioff:ioff + n_d * n_g].reshape(n_d, n_g)
        gig = g_ig[goff:goff + n_g]
        crowd = iscrowd[goff:goff + n_g].astype(bool)
        order = np.argsort(gig, kind="mergesort")
        gig_s = gig[order].astype(bool)
        crowd_s = crowd[order]
        ious_s = ious[:, order]
        n_non = int(np.count_nonzero(~gig_s))
        for ti, t in enumerate(IOU_THRS):
            thr = min(t, 1 - 1e-10)
            taken = np.zeros(n_g, bool)
            for di in range(n_d):
                row = ious_s[di]
                avail = ~taken | crowd_s
                m = -1
                c1 = avail[:n_non] & (row[:n_non] >= thr)
                if c1.any():
                    v = row[:n_non]
                    mx = v[c1].max()
                    m = int(np.flatnonzero(c1 & (v >= mx))[-1])
                else:
                    c2 = avail[n_non:] & (row[n_non:] >= thr)
                    if c2.any():
                        v = row[n_non:]
                        mx = v[c2].max()
                        m = n_non + int(np.flatnonzero(c2 & (v >= mx))[-1])
                if m == -1:
                    ignored[ti, doff + di] = dout[di]
                    continue
                matched[ti, doff + di] = True
                ignored[ti, doff + di] = bool(gig_s[m])
                taken[m] = True
        ioff += n_d * n_g
        goff += n_g
        doff += n_d
    return matched, ignored


class COCOEvaluator:
    """Accumulate detections, then score against a COCOIndex ground truth.

    Detections: dicts {image_id, category_id, bbox (tlwh), score} — the COCO
    results-JSON row format the reference emits (engine/build.py:159-164).
    """

    def __init__(self, coco_index, img_ids: Optional[Sequence[int]] = None,
                 cat_ids: Optional[Sequence[int]] = None):
        self.coco = coco_index
        self.img_ids = list(img_ids) if img_ids is not None else coco_index.get_img_ids()
        self.cat_ids = sorted(cat_ids) if cat_ids is not None else sorted(
            coco_index.get_cat_ids())
        self._dts: Dict[tuple, List[Dict]] = defaultdict(list)
        self.stats: Optional[np.ndarray] = None

    def add_detection(self, image_id: int, category_id: int,
                      bbox_tlwh: Sequence[float], score: float) -> None:
        self._dts[(int(image_id), int(category_id))].append(
            {"bbox": np.asarray(bbox_tlwh, np.float64), "score": float(score)})

    def add_detections(self, rows: Sequence[Dict]) -> None:
        for row in rows:
            self.add_detection(row["image_id"], row["category_id"],
                               row["bbox"], row["score"])

    # ------------------------------------------------------------------
    def _per_image_arrays(self, cat_id: int, gts_by_img_cat) -> Optional[list]:
        """Per-image (ious, gig_base, g_area, iscrowd, scores, d_area) for one
        category: IoU computed once here, in (score-sorted dt, original gt)
        order, reused for all four area ranges. None if the category is
        empty everywhere (pycocotools: all evaluateImg results None)."""
        max_det_cap = max(MAX_DETS)
        imgs = []
        any_data = False
        for img_id in self.img_ids:
            anns = gts_by_img_cat.get((img_id, cat_id), ())
            dts = self._dts.get((img_id, cat_id), ())
            if not anns and not dts:
                continue
            any_data = True
            n_g = len(anns)
            g_bbox = np.array([a["bbox"] for a in anns],
                              np.float64).reshape(n_g, 4)
            g_area = np.array(
                [float(a["area"]) if "area" in a else
                 float(a["bbox"][2] * a["bbox"][3]) for a in anns], np.float64)
            iscrowd = np.array([int(a.get("iscrowd", 0)) for a in anns],
                               np.uint8)
            gig_base = np.array(
                [1 if (a.get("ignore", 0) or a.get("iscrowd", 0)) else 0
                 for a in anns], np.uint8)
            scores = np.array([d["score"] for d in dts], np.float64)
            order = np.argsort(-scores, kind="mergesort")[:max_det_cap]
            d_bbox = np.array([dts[i]["bbox"] for i in order],
                              np.float64).reshape(len(order), 4)
            scores = scores[order]
            d_area = d_bbox[:, 2] * d_bbox[:, 3]
            ious = _iou_tlwh(d_bbox, g_bbox, iscrowd)
            imgs.append((ious, gig_base, g_area, iscrowd, scores, d_area))
        return imgs if any_data else None

    def evaluate(self, verbose: bool = True) -> np.ndarray:
        """Run the full protocol; returns the 12-entry stats vector."""
        t_count, r_count = len(IOU_THRS), len(REC_THRS)
        k_count, a_count, m_count = len(self.cat_ids), len(AREA_ORDER), len(MAX_DETS)
        precision = -np.ones((t_count, r_count, k_count, a_count, m_count))
        recall = -np.ones((t_count, k_count, a_count, m_count))

        cat_set = set(self.cat_ids)
        gts_by_img_cat: Dict[tuple, List[Dict]] = {}
        for img_id in self.img_ids:
            for ann in self.coco.load_anns(img_id):
                cid = ann["category_id"]
                if cid in cat_set:
                    gts_by_img_cat.setdefault((img_id, cid), []).append(ann)

        for ki, cat_id in enumerate(self.cat_ids):
            imgs = self._per_image_arrays(cat_id, gts_by_img_cat)
            if imgs is None:
                continue
            nd_arr = np.array([len(p[4]) for p in imgs], np.int64)
            ng_arr = np.array([len(p[1]) for p in imgs], np.int64)
            ious_flat = (np.concatenate([p[0].reshape(-1) for p in imgs])
                         if imgs else np.zeros(0))
            gig_base = np.concatenate([p[1] for p in imgs])
            g_area = np.concatenate([p[2] for p in imgs])
            iscrowd = np.concatenate([p[3] for p in imgs])
            scores = np.concatenate([p[4] for p in imgs])
            d_area = np.concatenate([p[5] for p in imgs])
            ranks = (np.concatenate([np.arange(n) for n in nd_arr])
                     if len(nd_arr) else np.zeros(0, np.int64))

            # global score order per maxDet cap: same for every area range
            m_cols = []
            for max_det in MAX_DETS:
                cols = np.flatnonzero(ranks < max_det)
                order = np.argsort(-scores[cols], kind="mergesort")
                m_cols.append(cols[order])

            for ai, a_lbl in enumerate(AREA_ORDER):
                lo, hi = AREA_RNG[a_lbl]
                g_ig = (gig_base.astype(bool)
                        | (g_area < lo) | (g_area > hi)).astype(np.uint8)
                n_gt = int(np.count_nonzero(g_ig == 0))
                if n_gt == 0:
                    continue
                d_out = ((d_area < lo) | (d_area > hi)).astype(np.uint8)
                matched, ignored = _match_batch(
                    ious_flat, g_ig, iscrowd, d_out, nd_arr, ng_arr)
                for mi in range(m_count):
                    cols = m_cols[mi]
                    self._accumulate(matched[:, cols], ignored[:, cols],
                                     n_gt, precision, recall, ki, ai, mi)

        self._precision = precision
        self._recall = recall
        self.stats = self._summarize(verbose)
        return self.stats

    @staticmethod
    def _accumulate(matched, ignored, n_gt, precision, recall, ki, ai, mi):
        """pycocotools accumulate for one (cat, area, maxDet) cell: matched/
        ignored are [T, N] bool with columns in global descending-score order
        (ties broken by image order — stable mergesort over the concatenated
        per-image score lists, as pycocotools does)."""
        t_count = len(IOU_THRS)
        n = matched.shape[1]
        if n == 0:
            recall[:, ki, ai, mi] = 0.0
            precision[:, :, ki, ai, mi] = 0.0
            return
        tps = matched & ~ignored
        fps = ~matched & ~ignored
        tp = np.cumsum(tps, axis=1).astype(np.float64)
        fp = np.cumsum(fps, axis=1).astype(np.float64)
        rc = tp / n_gt
        # pycocotools: tp/(fp+tp+spacing), the exact formula
        pr = tp / (fp + tp + np.spacing(1))
        recall[:, ki, ai, mi] = rc[:, -1]
        pr_env = np.maximum.accumulate(pr[:, ::-1], axis=1)[:, ::-1]
        for ti in range(t_count):
            inds = np.searchsorted(rc[ti], REC_THRS, side="left")
            q = np.zeros(len(REC_THRS))
            ok = inds < n
            q[ok] = pr_env[ti, inds[ok]]
            precision[ti, :, ki, ai, mi] = q

    # ------------------------------------------------------------------
    def _summary_value(self, ap: bool, iou: Optional[float], area: str,
                       max_det: int) -> float:
        ai = AREA_ORDER.index(area)
        mi = MAX_DETS.index(max_det)
        if ap:
            s = self._precision
            s = s[:, :, :, ai, mi] if iou is None else \
                s[np.where(np.isclose(IOU_THRS, iou))[0], :, :, ai, mi]
        else:
            s = self._recall
            s = s[:, :, ai, mi] if iou is None else \
                s[np.where(np.isclose(IOU_THRS, iou))[0], :, ai, mi]
        valid = s[s > -1]
        return float(np.mean(valid)) if valid.size else -1.0

    def _summarize(self, verbose: bool) -> np.ndarray:
        rows = [
            (True, None, "all", 100), (True, 0.5, "all", 100),
            (True, 0.75, "all", 100), (True, None, "small", 100),
            (True, None, "medium", 100), (True, None, "large", 100),
            (False, None, "all", 1), (False, None, "all", 10),
            (False, None, "all", 100), (False, None, "small", 100),
            (False, None, "medium", 100), (False, None, "large", 100),
        ]
        stats = np.array([self._summary_value(*r) for r in rows])
        if verbose:
            for (ap, iou, area, md), v in zip(rows, stats):
                kind = "Average Precision" if ap else "Average Recall"
                metric = "(AP)" if ap else "(AR)"
                iou_s = "0.50:0.95" if iou is None else f"{iou:0.2f}"
                print(f" {kind:<18} {metric} @[ IoU={iou_s:<9} | "
                      f"area={area:>6s} | maxDets={md:>3d} ] = {v:0.3f}")
        return stats
