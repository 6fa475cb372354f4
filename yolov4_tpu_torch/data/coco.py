"""COCO: a first-party annotation index and the detection dataset, the
port's copies of the JAX package's data/coco.py.

``COCOIndex`` is the pycocotools.coco.COCO subset the evaluator needs:
images, per-image annotations (crowds included, the reference's
``getAnnIds(iscrowd=None)``) and categories. ``COCODataset`` reads
``root/images/{name}/{id:012}.jpg`` and ``root/annotations/
instances_{train,val}2017.json`` (reference cocodataset.py:58-156): boxes
kept when wider and taller than 1 pixel and in class range, rows reversed
against file order (the reference's ``insert(0, ...)``); in training with
mosaic, three extra images drawn at random, each redrawn until it has
labels; a mutable ``img_size`` for multi-scale schedules.
"""

from __future__ import annotations

import json
import os
import random
from typing import Dict, List, Optional

import cv2
import numpy as np

# The standard COCO tables (reference cocodataset.py:24-55): 91 label names
# including background, and the 80 instance category ids.
COCO_LABEL_NAMES = (
    "background",
    "person", "bicycle", "car", "motorcycle", "airplane", "bus", "train",
    "truck", "boat", "traffic light", "fire hydrant", "street sign",
    "stop sign", "parking meter", "bench", "bird", "cat", "dog", "horse",
    "sheep", "cow", "elephant", "bear", "zebra", "giraffe", "hat",
    "backpack", "umbrella", "shoe", "eye glasses", "handbag", "tie",
    "suitcase", "frisbee", "skis", "snowboard", "sports ball", "kite",
    "baseball bat", "baseball glove", "skateboard", "surfboard",
    "tennis racket", "bottle", "plate", "wine glass", "cup", "fork",
    "knife", "spoon", "bowl", "banana", "apple", "sandwich", "orange",
    "broccoli", "carrot", "hot dog", "pizza", "donut", "cake", "chair",
    "couch", "potted plant", "bed", "mirror", "dining table", "window",
    "desk", "toilet", "door", "tv", "laptop", "mouse", "remote",
    "keyboard", "cell phone", "microwave", "oven", "toaster", "sink",
    "refrigerator", "blender", "book", "clock", "vase", "scissors",
    "teddy bear", "hair drier", "toothbrush",
)

# model class index (0..79) -> COCO category id
COCO_CLASS_IDS = [
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 14, 15, 16, 17, 18, 19, 20,
    21, 22, 23, 24, 25, 27, 28, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40,
    41, 42, 43, 44, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 67, 70, 72, 73, 74, 75, 76, 77, 78, 79,
    80, 81, 82, 84, 85, 86, 87, 88, 89, 90,
]


class COCOIndex:
    """Minimal COCO instances-JSON index (pycocotools.coco.COCO subset)."""

    def __init__(self, annotation_file: str):
        with open(annotation_file, "r") as f:
            blob = json.load(f)
        self.images: List[Dict] = blob.get("images", [])
        self.categories: List[Dict] = blob.get("categories", [])
        self.img_info: Dict[int, Dict] = {img["id"]: img for img in self.images}
        self.anns_by_img: Dict[int, List[Dict]] = {img["id"]: [] for img in self.images}
        for ann in blob.get("annotations", []):
            self.anns_by_img.setdefault(ann["image_id"], []).append(ann)

    def get_img_ids(self) -> List[int]:
        return [img["id"] for img in self.images]

    def get_cat_ids(self) -> List[int]:
        return [cat["id"] for cat in self.categories]

    def load_anns(self, img_id: int) -> List[Dict]:
        """All annotations for an image, crowds included
        (reference getAnnIds(iscrowd=None), cocodataset.py:99)."""
        return self.anns_by_img.get(img_id, [])


class COCODataset:
    """A COCO split over its directory layout (reference
    cocodataset.py:58-156). The port's default is val2017 for evaluation
    (its first callers); the JAX package's is train2017.

    ``dataset[i]`` -> (image, target): the transform's output for image i
    (and, in training with mosaic, three random others) and its labels,
    with ``target['img_info']`` extended by [img_id, i].
    """

    MIN_SIZE = 1  # boxes must be wider and taller than this, in pixels

    def __init__(self, root: str, img_size: int, transform,
                 num_classes: int = 80, name: str = "val2017",
                 is_train: bool = False, seed: Optional[int] = None):
        self.root = root
        self.name = name
        self.img_size = img_size
        self.transform = transform
        self.num_classes = num_classes
        self.is_train = is_train
        if "train" in name:
            json_file = "instances_train2017.json"
        elif "val" in name:
            json_file = "instances_val2017.json"
        else:
            raise ValueError(f"{name} does not match any files")
        annotation_file = os.path.join(root, "annotations", json_file)
        if not os.path.isfile(annotation_file):
            raise FileNotFoundError(
                f"COCO annotations not found: {annotation_file} — expected "
                f"layout: {root}/annotations/{json_file} + "
                f"{root}/images/{name}/*.jpg")
        self.coco = COCOIndex(annotation_file)
        self.ids = self.coco.get_img_ids()
        self.class_ids = sorted(self.coco.get_cat_ids())
        self._py_rng = random.Random(seed)

    def __len__(self) -> int:
        return len(self.ids)

    def seed(self, seed: Optional[int]) -> None:
        """Re-seed the mosaic draws and the transform's generators."""
        self._py_rng = random.Random(seed)
        if self.transform is not None and hasattr(self.transform, "seed"):
            self.transform.seed(seed)

    def img_path(self, img_id: int) -> str:
        return os.path.join(self.root, "images", self.name, f"{img_id:012}.jpg")

    def get_img_and_labels(self, index: Optional[int] = None):
        """(BGR uint8 image, [N, 5] tlwh+cls float array, img_id); a random
        image when ``index`` is None."""
        if index is None:
            index = self._py_rng.randrange(len(self.ids))
        img_id = self.ids[index]
        path = self.img_path(img_id)
        img = cv2.imread(path)
        if img is None:
            raise FileNotFoundError(path)
        rows = []
        for ann in self.coco.load_anns(int(img_id)):
            bbox = ann["bbox"]
            if bbox[2] > self.MIN_SIZE and bbox[3] > self.MIN_SIZE:
                rows.insert(0, list(bbox)
                            + [self.class_ids.index(ann["category_id"])])
        bboxes = np.array(rows, dtype=np.float64)
        if len(bboxes) > 0:
            keep = (bboxes[:, 4] < self.num_classes) & (bboxes[:, 4] >= 0)
            bboxes = bboxes[keep]
        return img, bboxes, img_id

    def __getitem__(self, index: int):
        img, bboxes, img_id = self.get_img_and_labels(index)
        img_list, bboxes_list = [img], [bboxes]
        if self.is_train and getattr(self.transform, "is_mosaic", False):
            for _ in range(3):
                # the reference redraws until the extra image has labels
                # (cocodataset.py:124-133); a dataset where none has any
                # fails here instead of hanging a loader worker
                extra_img, extra_boxes, _ = self.get_img_and_labels()
                tries = 0
                while len(extra_boxes) == 0:
                    tries += 1
                    if tries > max(1000, 4 * len(self)):
                        raise RuntimeError(
                            "mosaic: no image with surviving labels found "
                            f"after {tries} draws — every annotation is "
                            "filtered out (min_size/class filters); "
                            "disable AUGMENTATION.IS_MOSAIC or fix the "
                            "dataset")
                    extra_img, extra_boxes, _ = self.get_img_and_labels()
                img_list.append(extra_img)
                bboxes_list.append(extra_boxes)
        out_img, target = self.transform(img_list, bboxes_list, self.img_size)
        target["img_info"] = list(target["img_info"]) + [img_id, index]
        return out_img, target

    def set_img_size(self, img_size: int) -> None:
        self.img_size = img_size

    def get_img_size(self) -> int:
        return self.img_size
