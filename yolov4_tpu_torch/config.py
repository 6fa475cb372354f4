"""Config system: the port's own copy of the JAX package's defaults.

YAML config files with the reference's section/key layout (``config/*.cfg``
— YAML despite the extension). A config is a plain nested dict wrapped with
defaulting, validation and ``cfg['TEST']['IMGSIZE']`` access.

``MODEL.PALLAS_CSP`` (false, true or "auto" = on for CUDA tensors) is live:
it sends the eval forward of CSP stages 1-3 through the fused stage kernel
K2 (ops/csp_cuda.py), with BatchNorm folded into the convs; the default
stays false.

Keys that only steer TPU lowerings (``MODEL.S2D_STEM``, ``MODEL.WPACK``,
``MODEL.SPLIT_HEAD``, ``MODEL.QUANT*``, ``TEST.S2D_WIRE``,
``TEST.APPROX_TOPK``) are accepted and validated so that every config file
of the JAX package loads unchanged; the port runs the plain path they all
reduce to and ignores them.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Optional

import yaml

# Defaults mirror config/yolov4_Tianxiaomo.cfg in the reference repo.
DEFAULTS: Dict[str, Dict[str, Any]] = {
    "DATA": {
        "MAX_NUM_LABELS": 60,
        "BATCH_SIZE": 4,
        "WORKERS": 4,
    },
    "AUGMENTATION": {
        "RANDOM_RESIZE": True,
        "JITTER": 0.3,
        "RANDOM_HORIZONTAL_FLIP": True,
        "COLOR_DITHERING": True,
        "HUE": 0.1,
        "SATURATION": 1.5,
        "EXPOSURE": 1.5,
        "IS_MOSAIC": True,
        "MIN_OFFSET": 0.2,
    },
    "MODEL": {
        "TYPE": "YOLOv4",
        "BACKBONE": "cspdarknet53",
        "BACKBONE_PRETRAINED": None,
        "ANCHORS": [
            [12, 16], [19, 36], [40, 28],
            [36, 75], [76, 55], [72, 146],
            [142, 110], [192, 243], [459, 401],
        ],
        "ANCHOR_MASK": [[0, 1, 2], [3, 4, 5], [6, 7, 8]],
        "N_CLASSES": 80,
        # reference SPP quirk: the third pool reuses size 5 (5/9/5)
        "SPP_LEGACY_POOLS": True,
        "EXACT_POOL_GRAD": False,
        "COMPUTE_DTYPE": "bfloat16",
        # eval-time fused CSP stages 1-3 (K2): false | true | "auto"
        "PALLAS_CSP": False,
        # TPU lowerings of the same math; no-ops in the port
        "WPACK": "auto",
        "SPLIT_HEAD": "auto",
        "QUANT": "none",
        "QUANT_SPAN": "full",
        "QUANT_CHAIN": True,
        "QUANT_STEM": False,
    },
    "CRITERION": {
        "TYPE": "YOLOLoss",
        "IGNORE_THRESH": 0.7,
        "BOX_LOSS": "mse",
    },
    "OPTIMIZER": {
        "TYPE": "ADAM",
        "LR": 3e-4,
        "NO_BIAS": True,
        "NO_NORM": True,
        "MOMENTUM": 0.9,
        "DECAY": 5e-4,
    },
    "LR_SCHEDULER": {
        "TYPE": "MultiStepLR",
        "MILESTONES": [50, 70, 80],
        "GAMMA": 0.1,
        "IS_WARMUP": True,
        "WARMUP_EPOCH": 5,
        "MULTIPLIER": 1.0,
        "MINIMAL_LR": 1e-6,
    },
    "TRAIN": {
        "IMGSIZE": 608,
        "START_EPOCH": 0,
        "MAX_EPOCHS": 90,
        "ACCUMULATION_STEPS": 1,
        "OUTPUT_DIR": "./outputs/yolov4",
        "TRANSFER_DTYPE": "bfloat16",
        "TRANSFER_LAYOUT": "s2d",
        "CHECKPOINT_EVERY_STEPS": 0,
        "EMA_DECAY": 0.0,
        "MULTISCALE": [],
        "MULTISCALE_EVERY": 10,
    },
    "TEST": {
        "IMGSIZE": 608,
        "CONFTHRE": 0.005,
        "NMSTHRE": 0.4,
        # fixed-shape postprocessing sizes (see ops/postprocess.py)
        "BATCH_SIZE": 8,
        "PRE_NMS_TOPK": 2048,
        "MAX_DETS": 100,
        # pycocotools' per-(image, category) cap; 0 disables
        "CAT_CAP": 100,
        "APPROX_TOPK": False,
        # aspect-preserving letterbox eval geometry instead of stretch
        "LETTERBOX": False,
        "S2D_WIRE": True,
    },
}


def _deep_update(base: Dict[str, Any], override: Dict[str, Any]) -> Dict[str, Any]:
    for key, value in override.items():
        if (
            key in base
            and isinstance(base[key], dict)
            and isinstance(value, dict)
        ):
            _deep_update(base[key], value)
        else:
            base[key] = value
    return base


class Config(dict):
    """Nested dict with defaults. ``cfg['TRAIN']['IMGSIZE']`` style access,
    exactly like the reference's raw-YAML usage."""

    @classmethod
    def from_file(cls, path: str) -> "Config":
        with open(path, "r") as f:
            raw = yaml.safe_load(f) or {}
        return cls.from_dict(raw)

    @classmethod
    def from_dict(cls, raw: Optional[Dict[str, Any]] = None) -> "Config":
        merged = copy.deepcopy(DEFAULTS)
        if raw:
            _deep_update(merged, raw)
        cfg = cls(merged)
        cfg.validate()
        return cfg

    def validate(self) -> None:
        model = self["MODEL"]
        anchors = model["ANCHORS"]
        masks = model["ANCHOR_MASK"]
        if len(anchors) == 0 or any(len(a) != 2 for a in anchors):
            raise ValueError(f"MODEL.ANCHORS must be a list of [w, h]: {anchors}")
        flat = [i for mask in masks for i in mask]
        if sorted(flat) != list(range(len(anchors))):
            raise ValueError(
                f"MODEL.ANCHOR_MASK must partition range({len(anchors)}): {masks}"
            )
        if len(masks) != 3:
            raise ValueError("exactly 3 detection scales are supported")
        n_classes = model["N_CLASSES"]
        if n_classes < 1:
            raise ValueError(f"MODEL.N_CLASSES must be >= 1, got {n_classes}")
        for key in ("TRAIN", "TEST"):
            size = self[key]["IMGSIZE"]
            if size % 32 != 0:
                raise ValueError(f"{key}.IMGSIZE must be a multiple of 32: {size}")
        if self["TRAIN"]["ACCUMULATION_STEPS"] < 1:
            raise ValueError("TRAIN.ACCUMULATION_STEPS must be >= 1")
        if model.get("QUANT", "none") not in ("none", "int8", "int8_static"):
            raise ValueError("MODEL.QUANT must be 'none', 'int8', or "
                             f"'int8_static': {model['QUANT']}")
        if model.get("QUANT_SPAN", "late") not in ("late", "full"):
            raise ValueError("MODEL.QUANT_SPAN must be 'late' or 'full': "
                             f"{model['QUANT_SPAN']}")
        if model.get("COMPUTE_DTYPE", "bfloat16") not in ("float32", "bfloat16"):
            raise ValueError("MODEL.COMPUTE_DTYPE must be 'float32' or "
                             f"'bfloat16': {model['COMPUTE_DTYPE']}")
        if model.get("PALLAS_CSP", False) not in (False, True, "auto"):
            raise ValueError("MODEL.PALLAS_CSP must be false, true or "
                             f"'auto': {model['PALLAS_CSP']!r}")
        box_loss = self["CRITERION"].get("BOX_LOSS", "mse")
        if box_loss not in ("mse", "iou", "giou", "diou", "ciou"):
            raise ValueError("CRITERION.BOX_LOSS must be one of "
                             f"mse/iou/giou/diou/ciou: {box_loss}")
        ema = float(self["TRAIN"].get("EMA_DECAY", 0.0))
        if not 0.0 <= ema < 1.0:
            raise ValueError(f"TRAIN.EMA_DECAY must be in [0, 1): {ema}")
        ms = self["TRAIN"].get("MULTISCALE", []) or []
        if any(int(s) % 32 for s in ms):
            raise ValueError(
                f"TRAIN.MULTISCALE sizes must be multiples of 32: {ms}")
        if ms and int(self["TRAIN"].get("MULTISCALE_EVERY", 10)) < 1:
            raise ValueError("TRAIN.MULTISCALE_EVERY must be >= 1")


def load_config(path: Optional[str] = None) -> Config:
    if path is None:
        return Config.from_dict({})
    return Config.from_file(path)
