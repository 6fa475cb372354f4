"""ImageNet-style classification data (reference darknet/main_amp.py:
216-231, 29-41): the port's copy of the JAX package's classify/data.py.

Train: RandomResizedCrop(size) + RandomHorizontalFlip + RandAugment, uint8
HWC out (the normalization happens on the device, as in the reference's
data_prefetcher, main_amp.py:280-332). Val: Resize(short side) +
CenterCrop.

RandAugment follows torchvision's v0.13 defaults (num_ops=2, magnitude=9,
31 bins) with PIL's own ops: the same seed gives the JAX package's pixels,
bit for bit, and another image library would compute other pixels.
"""

from __future__ import annotations

import os
import random
from typing import List, Optional, Tuple

import numpy as np
from PIL import Image, ImageEnhance, ImageOps

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")

# device-side normalization constants (reference main_amp.py:284-285), on
# the 0-255 scale of the uint8 batch
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32) * 255.0
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32) * 255.0

_BINS = 31


def _signed(mag: float, rng: random.Random) -> float:
    return -mag if rng.random() < 0.5 else mag


class RandAugment:
    """torchvision-style RandAugment (num_ops random ops per image)."""

    def __init__(self, num_ops: int = 2, magnitude: int = 9):
        self.num_ops = num_ops
        self.magnitude = magnitude

    def _space(self, img_size: int):
        frac = self.magnitude / (_BINS - 1)
        return [
            ("identity", None),
            ("shear_x", 0.3 * frac),
            ("shear_y", 0.3 * frac),
            ("translate_x", 150.0 / 331.0 * img_size * frac),
            ("translate_y", 150.0 / 331.0 * img_size * frac),
            ("rotate", 30.0 * frac),
            ("brightness", 0.9 * frac),
            ("color", 0.9 * frac),
            ("contrast", 0.9 * frac),
            ("sharpness", 0.9 * frac),
            ("posterize", int(round(8 - 4 * frac))),
            ("solarize", 255.0 * (1 - frac)),
            ("autocontrast", None),
            ("equalize", None),
        ]

    def __call__(self, img: Image.Image, rng: random.Random) -> Image.Image:
        space = self._space(min(img.size))
        for _ in range(self.num_ops):
            name, mag = space[rng.randrange(len(space))]
            img = self._apply(img, name, mag, rng)
        return img

    @staticmethod
    def _apply(img, name, mag, rng):
        if name == "identity":
            return img
        if name == "shear_x":
            return img.transform(img.size, Image.AFFINE,
                                 (1, _signed(mag, rng), 0, 0, 1, 0))
        if name == "shear_y":
            return img.transform(img.size, Image.AFFINE,
                                 (1, 0, 0, _signed(mag, rng), 1, 0))
        if name == "translate_x":
            return img.transform(img.size, Image.AFFINE,
                                 (1, 0, _signed(mag, rng), 0, 1, 0))
        if name == "translate_y":
            return img.transform(img.size, Image.AFFINE,
                                 (1, 0, 0, 0, 1, _signed(mag, rng)))
        if name == "rotate":
            return img.rotate(_signed(mag, rng))
        if name == "brightness":
            return ImageEnhance.Brightness(img).enhance(1.0 + _signed(mag, rng))
        if name == "color":
            return ImageEnhance.Color(img).enhance(1.0 + _signed(mag, rng))
        if name == "contrast":
            return ImageEnhance.Contrast(img).enhance(1.0 + _signed(mag, rng))
        if name == "sharpness":
            return ImageEnhance.Sharpness(img).enhance(1.0 + _signed(mag, rng))
        if name == "posterize":
            return ImageOps.posterize(img, int(mag))
        if name == "solarize":
            return ImageOps.solarize(img, mag)
        if name == "autocontrast":
            return ImageOps.autocontrast(img)
        if name == "equalize":
            return ImageOps.equalize(img)
        raise ValueError(name)


def random_resized_crop(img: Image.Image, size: int, rng: random.Random,
                        scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3)) -> Image.Image:
    """torchvision's RandomResizedCrop: ten draws of area and aspect, then
    the center square."""
    w, h = img.size
    area = w * h
    for _ in range(10):
        target_area = area * rng.uniform(*scale)
        log_ratio = (np.log(ratio[0]), np.log(ratio[1]))
        aspect = np.exp(rng.uniform(*log_ratio))
        cw = int(round(np.sqrt(target_area * aspect)))
        ch = int(round(np.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            x = rng.randint(0, w - cw)
            y = rng.randint(0, h - ch)
            return img.resize((size, size), Image.BILINEAR,
                              box=(x, y, x + cw, y + ch))
    side = min(w, h)
    x = (w - side) // 2
    y = (h - side) // 2
    return img.resize((size, size), Image.BILINEAR,
                      box=(x, y, x + side, y + side))


def resize_center_crop(img: Image.Image, resize: int, crop: int) -> Image.Image:
    """Resize the short side to ``resize``, then the center ``crop``
    square."""
    w, h = img.size
    if w < h:
        nw, nh = resize, int(round(h * resize / w))
    else:
        nw, nh = int(round(w * resize / h)), resize
    img = img.resize((nw, nh), Image.BILINEAR)
    x = (nw - crop) // 2
    y = (nh - crop) // 2
    return img.crop((x, y, x + crop, y + crop))


class ImageFolderDataset:
    """torchvision.datasets.ImageFolder's layout, root/class_name/*.jpg:
    classes in sorted order, files sorted within each. Items are (uint8
    HWC image, {"label": int32}); ``seed`` reseeds the train augmentation
    (the loader calls it per sample)."""

    def __init__(self, root: str, crop_size: int = 256, val_size: int = 288,
                 is_train: bool = True, rand_augment: bool = True,
                 seed: Optional[int] = None):
        self.root = root
        self.crop_size = crop_size
        self.val_size = val_size
        self.is_train = is_train
        self.rand_augment = RandAugment() if (is_train and rand_augment) else None

        classes = sorted(d for d in os.listdir(root)
                         if os.path.isdir(os.path.join(root, d)))
        if not classes:
            raise FileNotFoundError(f"no class directories under {root}")
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples: List[Tuple[str, int]] = []
        for cls in classes:
            cdir = os.path.join(root, cls)
            for fname in sorted(os.listdir(cdir)):
                if fname.lower().endswith(IMG_EXTENSIONS):
                    self.samples.append((os.path.join(cdir, fname),
                                         self.class_to_idx[cls]))
        self._py_rng = random.Random(seed)

    def seed(self, seed: Optional[int]) -> None:
        self._py_rng = random.Random(seed)

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, index: int):
        path, label = self.samples[index]
        with Image.open(path) as f:
            img = f.convert("RGB")
        if self.is_train:
            img = random_resized_crop(img, self.crop_size, self._py_rng)
            if self._py_rng.random() < 0.5:
                img = img.transpose(Image.FLIP_LEFT_RIGHT)
            if self.rand_augment is not None:
                img = self.rand_augment(img, self._py_rng)
        else:
            img = resize_center_crop(img, self.val_size, self.crop_size)
        return np.asarray(img, np.uint8), {"label": np.int32(label)}
