"""Synthetic COCO datasets on disk, the port's copy of the generators the
JAX package's tests and learning smokes use (tests/fixtures.py there): the
same draws in the same order, so equal arguments write the same
annotation JSON and the same JPEGs.

``make_fake_coco`` draws random annotations (plumbing);
``make_shapes_coco`` draws DETECTABLE objects whose annotations match the
pixels (rectangles / circles / triangles as three classes, six with
``hard``), so a model trained on one split can be scored for genuine
generalization on a held-out split (tools/generalization_smoke.py)."""

import json
import os

import cv2
import numpy as np

from yolov4_tpu_torch.data.coco import COCO_CLASS_IDS, COCO_LABEL_NAMES


def make_fake_coco(root: str, name: str = "train2017", n_images: int = 6,
                   seed: int = 0, img_hw=(120, 160), max_boxes: int = 5):
    """Create root/images/{name}/*.jpg + root/annotations/instances_{name}.json.

    Returns the list of image ids."""
    rng = np.random.default_rng(seed)
    img_dir = os.path.join(root, "images", name)
    ann_dir = os.path.join(root, "annotations")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(ann_dir, exist_ok=True)

    images, annotations = [], []
    ann_id = 1
    ids = []
    for i in range(n_images):
        img_id = 1000 + i
        ids.append(img_id)
        h = int(img_hw[0] + rng.integers(-20, 20))
        w = int(img_hw[1] + rng.integers(-20, 20))
        img = rng.integers(0, 255, size=(h, w, 3), dtype=np.uint8)
        # draw some rectangles so detections have structure
        for _ in range(3):
            x, y = int(rng.integers(0, w - 20)), int(rng.integers(0, h - 20))
            cv2.rectangle(img, (x, y), (x + 18, y + 15),
                          tuple(int(c) for c in rng.integers(0, 255, 3)), -1)
        cv2.imwrite(os.path.join(img_dir, f"{img_id:012}.jpg"), img)
        images.append({"id": img_id, "file_name": f"{img_id:012}.jpg",
                       "height": h, "width": w})

        for _ in range(int(rng.integers(1, max_boxes + 1))):
            bw = float(rng.uniform(8, w / 2))
            bh = float(rng.uniform(8, h / 2))
            x = float(rng.uniform(0, w - bw))
            y = float(rng.uniform(0, h - bh))
            cat = int(COCO_CLASS_IDS[rng.integers(0, len(COCO_CLASS_IDS))])
            annotations.append({
                "id": ann_id, "image_id": img_id, "category_id": cat,
                "bbox": [x, y, bw, bh], "area": bw * bh, "iscrowd": 0,
                "segmentation": [],
            })
            ann_id += 1

    _write_instances(ann_dir, name, images, annotations)
    return ids


def _write_instances(ann_dir: str, name: str, images, annotations) -> None:
    categories = [
        {"id": cid, "name": COCO_LABEL_NAMES[idx + 1], "supercategory": "none"}
        for idx, cid in enumerate(COCO_CLASS_IDS)
    ]
    with open(os.path.join(ann_dir, f"instances_{name}.json"), "w") as f:
        json.dump({"images": images, "annotations": annotations,
                   "categories": categories}, f)


def _draw_shape(img, kind, cx, cy, half, color):
    """Draw one filled shape; returns its tight bbox (x, y, w, h)."""
    if kind == 0:  # rectangle
        x1, y1 = cx - half, cy - int(half * 0.7)
        x2, y2 = cx + half, cy + int(half * 0.7)
        cv2.rectangle(img, (x1, y1), (x2, y2), color, -1)
        return [x1, y1, x2 - x1, y2 - y1]
    if kind == 1:  # circle
        cv2.circle(img, (cx, cy), half, color, -1)
        return [cx - half, cy - half, 2 * half, 2 * half]
    if kind == 2:  # triangle (apex up)
        pts = np.array([[cx, cy - half], [cx - half, cy + half],
                        [cx + half, cy + half]], np.int32)
        cv2.fillPoly(img, [pts], color)
        return [cx - half, cy - half, 2 * half, 2 * half]
    if kind == 3:  # wide ellipse
        by = max(3, int(half * 0.55))
        cv2.ellipse(img, (cx, cy), (half, by), 0, 0, 360, color, -1)
        return [cx - half, cy - by, 2 * half, 2 * by]
    if kind == 4:  # plus / cross
        t = max(2, int(half * 0.4))
        cv2.rectangle(img, (cx - half, cy - t), (cx + half, cy + t), color, -1)
        cv2.rectangle(img, (cx - t, cy - half), (cx + t, cy + half), color, -1)
        return [cx - half, cy - half, 2 * half, 2 * half]
    # kind 5: ring (hollow circle — only a thin annulus carries the color)
    cv2.circle(img, (cx, cy), half - 1, color,
               thickness=max(2, half // 3))
    return [cx - half, cy - half, 2 * half, 2 * half]


def make_shapes_coco(root: str, name: str = "train2017", n_images: int = 64,
                     seed: int = 0, img_hw=(320, 320), max_shapes: int = 4,
                     id_base: int = 1000, hard: bool = False):
    """Detectable-object synthetic COCO: each image holds 1..max_shapes
    non-degenerate colored shapes on a noisy background; the annotation of
    every shape is its true tight bbox and its class is the shape kind
    (0=rectangle, 1=circle, 2=triangle, mapped to the first three COCO
    category ids). Disjoint seeds give disjoint image sets, so a held-out
    split measures generalization, not memorization.

    ``hard=True`` (a harder learning-evidence task) doubles
    the class count to 6 (adds ellipse / cross / ring — the ring is
    hollow, so color alone cannot classify it), raises the shape count to
    8 per image (overlap -> real occlusion), and draws scales
    log-uniformly from ~min/40 to ~min/4 so the anchors across all three
    detection scales see matched objects. The default path makes exactly
    the same RNG draws as before — recorded curves stay reproducible."""
    rng = np.random.default_rng(seed)
    n_kinds = 6 if hard else 3
    if hard:
        max_shapes = max(max_shapes, 8)
    img_dir = os.path.join(root, "images", name)
    ann_dir = os.path.join(root, "annotations")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(ann_dir, exist_ok=True)

    h, w = img_hw
    images, annotations = [], []
    ann_id = 1
    ids = []
    for i in range(n_images):
        img_id = id_base + i
        ids.append(img_id)
        # low-contrast noisy background
        img = rng.integers(90, 150, size=(h, w, 3), dtype=np.uint8)
        n_shapes = int(rng.integers(1, max_shapes + 1))
        for _ in range(n_shapes):
            kind = int(rng.integers(0, n_kinds))
            if hard:
                # log-uniform scales, tiny through large
                half_lo = max(4, min(h, w) // 40)
                half_hi = max(half_lo + 2, min(h, w) // 4)
                half = int(round(np.exp(rng.uniform(
                    np.log(half_lo), np.log(half_hi)))))
            else:
                # [18, min/5) at the default 320 size (the recorded-AP
                # distribution); clamped so small img_hw stays valid
                half_lo = min(18, max(6, min(h, w) // 8))
                half_hi = max(half_lo + 1, min(h, w) // 5)
                half = int(rng.integers(half_lo, half_hi))
            cx = int(rng.integers(half + 2, w - half - 2))
            cy = int(rng.integers(half + 2, h - half - 2))
            # saturated colors, far from the background band
            color = tuple(int(c) for c in rng.choice([30, 220], 3)
                          + rng.integers(-20, 20, 3))
            bbox = _draw_shape(img, kind, cx, cy, half, color)
            annotations.append({
                "id": ann_id, "image_id": img_id,
                "category_id": int(COCO_CLASS_IDS[kind]),
                "bbox": [float(v) for v in bbox],
                "area": float(bbox[2] * bbox[3]), "iscrowd": 0,
                "segmentation": [],
            })
            ann_id += 1
        cv2.imwrite(os.path.join(img_dir, f"{img_id:012}.jpg"), img)
        images.append({"id": img_id, "file_name": f"{img_id:012}.jpg",
                       "height": h, "width": w})

    _write_instances(ann_dir, name, images, annotations)
    return ids


class MemoryIndex:
    """The COCOIndex surface the evaluator reads (image ids, category ids,
    per-image annotations) over annotation dicts held in memory."""

    def __init__(self, anns, img_ids, cat_ids):
        self._by_img = {}
        for a in anns:
            self._by_img.setdefault(a["image_id"], []).append(a)
        self._img_ids = list(img_ids)
        self._cat_ids = list(cat_ids)

    def get_img_ids(self):
        return self._img_ids

    def get_cat_ids(self):
        return self._cat_ids

    def load_anns(self, img_id):
        return self._by_img.get(img_id, [])


def val2017_scale_case(n_img: int = 5000, seed: int = 0):
    """An in-memory detection set of val2017's shape for timing the
    evaluator: ``n_img`` images, 80 categories, 7 gts an image (2 % crowd)
    and 100 detections an image, half of them perturbed gts (dense true
    positives), half random. The draws of the JAX package's val2017-scale
    COCOeval timing test, in order. Returns (MemoryIndex, detection rows)."""
    rng = np.random.default_rng(seed)
    n_cat = 80
    img_ids = list(range(1, n_img + 1))
    cat_ids = list(range(1, n_cat + 1))
    anns = []
    gts_by_img = {}
    for img in img_ids:
        mine = []
        for _ in range(7):
            a = {"image_id": img,
                 "category_id": int(rng.integers(1, n_cat + 1)),
                 "bbox": [float(rng.uniform(0, 500)),
                          float(rng.uniform(0, 500)),
                          float(rng.uniform(1, 120)),
                          float(rng.uniform(1, 120))],
                 "iscrowd": int(rng.random() < 0.02)}
            anns.append(a)
            mine.append(a)
        gts_by_img[img] = mine
    dts = []
    for img in img_ids:
        mine = gts_by_img[img]
        for k in range(100):
            if k % 2 == 0:
                src = mine[k % len(mine)]
                bb = [src["bbox"][0] + float(rng.uniform(-4, 4)),
                      src["bbox"][1] + float(rng.uniform(-4, 4)),
                      max(1.0, src["bbox"][2] * float(rng.uniform(0.9, 1.1))),
                      max(1.0, src["bbox"][3] * float(rng.uniform(0.9, 1.1)))]
                cat = src["category_id"]
            else:
                bb = [float(rng.uniform(0, 500)), float(rng.uniform(0, 500)),
                      float(rng.uniform(1, 120)), float(rng.uniform(1, 120))]
                cat = int(rng.integers(1, n_cat + 1))
            dts.append({"image_id": img, "category_id": cat, "bbox": bb,
                        "score": float(rng.random())})
    return MemoryIndex(anns, img_ids, cat_ids), dts
