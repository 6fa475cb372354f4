"""Batched inference: forward + decode + NMS on the device.

The device program takes uint8 NHWC batches padded to a static batch size
to fixed-shape detections; the host only unmaps coordinates back to the
source images. Port of the JAX package's engine/predictor.py, planar path
only: the uint8 batch is uploaded as it is, then permuted to NCHW and
normalized by 1/255 on the device (the permuted view is channels-last in
memory, the layout cuDNN's NHWC kernels read directly).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from yolov4_tpu_torch.models import build_model
from yolov4_tpu_torch.ops.postprocess import postprocess


def pad_batch(images: np.ndarray, batch_size: int) -> np.ndarray:
    """Zero-pad an NHWC host batch to ``batch_size`` rows (one static
    device shape per predictor)."""
    n = images.shape[0]
    if n > batch_size:
        raise ValueError(f"batch {n} exceeds the predictor's size {batch_size}")
    if n < batch_size:
        pad = np.zeros((batch_size - n, *images.shape[1:]), images.dtype)
        images = np.concatenate([images, pad])
    return np.ascontiguousarray(images)


def resolve_device(device=None) -> torch.device:
    """The entry points' device rule: CUDA unless the caller names another
    device. Asking for CUDA where there is none raises; nothing falls back
    to the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA was requested but torch.cuda.is_available() "
                           "is False; pass device='cpu' to run on the CPU")
    return device


class Predictor:
    """Static-batch detector on one device.

    ``state_dict``: weights in the port's (= the reference's) key layout;
    None keeps the reference init drawn from seed 0 (``build_model``).
    ``device``: None means CUDA.
    """

    def __init__(self, cfg: Dict, state_dict: Optional[Dict] = None,
                 img_size: Optional[int] = None, batch_size: int = 8,
                 conf_thre: Optional[float] = None,
                 nms_thre: Optional[float] = None,
                 device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.model = build_model(cfg, device=self.device)
        if state_dict is not None:
            self.model.load_state_dict(state_dict)
        self.model.eval()
        if self.device.type == "cuda":
            self.model = self.model.to(memory_format=torch.channels_last)
        self.img_size = img_size or cfg["TEST"]["IMGSIZE"]
        self.batch_size = batch_size
        test = cfg["TEST"]
        self.conf_thre = test["CONFTHRE"] if conf_thre is None else conf_thre
        self.nms_thre = test["NMSTHRE"] if nms_thre is None else nms_thre
        self.num_classes = cfg["MODEL"]["N_CLASSES"]
        self.pre_nms_topk = test.get("PRE_NMS_TOPK", 2048)
        self.max_dets = test.get("MAX_DETS", 100)
        self.topk_approx = bool(test.get("APPROX_TOPK", False))
        # pycocotools-style per-(image, category) cap; when the fixed-size
        # output is deeper than it, also count scoring-relevant rows
        self.cat_cap = int(test.get("CAT_CAP", 100))
        self.count_relevant = bool(self.cat_cap
                                   and self.max_dets > self.cat_cap)

    @torch.inference_mode()
    def run(self, images: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """Device program on a uint8 NHWC device batch: normalize, forward,
        decode, postprocess. Returns device tensors (detections, valid
        [, relevant_count])."""
        x = images.permute(0, 3, 1, 2).float() / 255.0
        preds = self.model(x)
        return postprocess(
            preds, self.num_classes, self.conf_thre, self.nms_thre,
            pre_nms_topk=self.pre_nms_topk, max_dets=self.max_dets,
            topk_approx=self.topk_approx, cat_cap=self.cat_cap,
            return_relevant_count=self.count_relevant)

    def upload(self, images: np.ndarray) -> torch.Tensor:
        """Pad a uint8 NHWC host batch and copy it to the device."""
        if images.dtype != np.uint8:
            raise TypeError(f"images must be uint8 NHWC, got {images.dtype}")
        host = torch.from_numpy(pad_batch(images, self.batch_size))
        if self.device.type == "cuda":
            host = host.pin_memory()
        return host.to(self.device, non_blocking=True)

    def dispatch(self, images: np.ndarray) -> Tuple[torch.Tensor, ...]:
        """Upload and run without waiting: returns device tensors
        (detections, valid[, relevant_count])."""
        return self.run(self.upload(images))

    def warmup(self) -> None:
        """Run the program once on a zero batch (cuDNN picks its
        algorithms and the NMS kernel is built)."""
        out = self.dispatch(np.zeros(
            (self.batch_size, self.img_size, self.img_size, 3), np.uint8))
        out[0].cpu()

    def __call__(self, images: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Synchronous predict. images: [B, S, S, 3] uint8, B <= batch_size.

        Returns (detections [B, max_dets, 7], valid [B, max_dets]) numpy,
        rows = x1, y1, x2, y2, obj, cls_conf, cls_idx in input pixels.
        """
        n = images.shape[0]
        out = self.dispatch(images)
        return out[0][:n].cpu().numpy(), out[1][:n].cpu().numpy()
