"""Batched inference: forward + decode + NMS on the device.

The device program takes a flat planar wire batch ``[B, 3*S*S]`` (uint8,
or float32 in [0, 1]) padded to a static batch size to fixed-shape
detections; the host only unmaps coordinates back to the source images.
Port of the JAX package's engine/predictor.py, planar wire only (its s2d
wire is a TPU lowering). ``detection_program`` is that program, shared by
the live ``Predictor`` and the exported serving artifact
(utils/export.py), so that the two compute the same function op for op.

``dispatch`` uploads a uint8 NHWC host batch as it is, runs the program
on its channels-last NCHW view (``detection_forward``, the program after
the wire's reshape) and enqueues the copies of its outputs into pinned
host memory behind a CUDA event; ``fetch_local`` waits on that event
alone, so a fetch never waits behind batches dispatched after it (the
serving batcher keeps several in flight). Both bind the predictor's card,
so they may run in any host thread.
"""

from __future__ import annotations

from contextlib import nullcontext
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

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


def pack_wire(images: np.ndarray, batch_size: int) -> np.ndarray:
    """An NHWC host batch as the flat planar wire: padded to
    ``batch_size``, channels first, flattened to [batch_size, 3*S*S] (the
    JAX package's ``pack_wire`` without its s2d layout)."""
    padded = pad_batch(images, batch_size)
    return np.ascontiguousarray(padded.transpose(0, 3, 1, 2)).reshape(
        batch_size, -1)


def nhwc_to_wire(images: torch.Tensor) -> torch.Tensor:
    """A uint8 (or float32) NHWC device batch as the flat planar wire."""
    return images.permute(0, 3, 1, 2).reshape(images.shape[0], -1)


def detection_forward(model: nn.Module, x: torch.Tensor,
                      settings: Dict) -> Tuple[torch.Tensor, ...]:
    """An NCHW batch (uint8, normalized by 1/255 here, or float32 in
    [0, 1]; any strides) -> channels-last input -> forward -> decode ->
    postprocess (K1). Returns (detections, valid[, relevant_count]).
    ``settings``: the keyword arguments of ops/postprocess.postprocess
    after its first two."""
    x = x.float() / 255.0 if x.dtype == torch.uint8 else x.float()
    preds = model(x.contiguous(memory_format=torch.channels_last))
    return postprocess(preds, **settings)


def detection_program(model: nn.Module, flat: torch.Tensor, img_size: int,
                      settings: Dict) -> Tuple[torch.Tensor, ...]:
    """The serving program on the planar wire [B, 3*S*S]: reshaped to
    NCHW, then ``detection_forward``."""
    return detection_forward(
        model, flat.reshape(flat.shape[0], 3, img_size, img_size), settings)


class DetectionProgram(nn.Module):
    """``detection_program`` with its model and settings bound: what
    utils/export.py traces."""

    def __init__(self, model: nn.Module, img_size: int, settings: Dict):
        super().__init__()
        self.model = model
        self.img_size = img_size
        self.settings = dict(settings)

    def forward(self, flat: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        return detection_program(self.model, flat, self.img_size,
                                 self.settings)


@dataclass(frozen=True)
class Dispatched:
    """One dispatched batch: ``host``, its outputs (detections, valid[,
    relevant_count]) as copies in pinned host memory (the outputs
    themselves on the CPU), and ``event``, recorded after those copies
    (None on the CPU)."""

    host: Tuple[torch.Tensor, ...]
    event: Optional["torch.cuda.Event"]


def upload_nhwc(images: np.ndarray, batch_size: int,
                device: torch.device) -> torch.Tensor:
    """Pad an NHWC host batch and copy it to ``device`` (through pinned
    memory, without waiting, to a card)."""
    host = torch.from_numpy(pad_batch(images, batch_size))
    if device.type == "cuda":
        host = host.pin_memory()
    return host.to(device, non_blocking=True)


def start_fetch(outs: Tuple[torch.Tensor, ...],
                device: torch.device) -> Dispatched:
    """Enqueue the copies of ``outs`` into fresh pinned host tensors on the
    current stream and record an event after them. PyTorch's caching host
    allocator hands a pinned block out again only once the copy that used
    it has completed, so the buffers of batches in flight never alias."""
    if device.type != "cuda":
        return Dispatched(tuple(outs), None)
    host = [torch.empty(o.shape, dtype=o.dtype, pin_memory=True)
            for o in outs]
    for h, o in zip(host, outs):
        h.copy_(o, non_blocking=True)
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device))
    return Dispatched(tuple(host), event)


def fetch_local(out: Dispatched) -> Tuple[np.ndarray, ...]:
    """The outputs of one dispatched batch as numpy arrays (all rows,
    padding included), after waiting for its own copies only."""
    if out.event is not None:
        out.event.synchronize()
    return tuple(h.numpy() for h in out.host)


def device_scope(device: torch.device):
    """Make ``device`` the current card of the calling thread (new threads
    start on card 0)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return nullcontext()


def resolve_device(device=None) -> torch.device:
    """The entry points' device rule: CUDA unless the caller names another
    device (``cuda:N`` for a rank's card). Asking for CUDA where there is
    none, or for a card index that does not exist, raises; nothing falls
    back to the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA was requested but torch.cuda.is_available() "
                           "is False; pass device='cpu' to run on the CPU")
    if (device.type == "cuda" and device.index is not None
            and device.index >= torch.cuda.device_count()):
        raise RuntimeError(f"{device} was requested but there are "
                           f"{torch.cuda.device_count()} CUDA device(s)")
    return device


class Predictor:
    """Static-batch detector on one device.

    ``state_dict``: weights in the port's (= the reference's) key layout;
    None keeps the reference init drawn from seed 0 (``build_model``).
    ``model``: an already built and loaded model to share (the serving
    runtime's buckets share one set of weights on the card); ``cfg`` and
    ``state_dict`` then do not build it again. ``device``: None means
    CUDA.
    """

    def __init__(self, cfg: Dict, state_dict: Optional[Dict] = None,
                 img_size: Optional[int] = None, batch_size: int = 8,
                 conf_thre: Optional[float] = None,
                 nms_thre: Optional[float] = None,
                 device=None, model: Optional[nn.Module] = None):
        self.device = resolve_device(device)
        self.cfg = cfg
        if model is None:
            model = build_model(cfg, device=self.device)
            if state_dict is not None:
                model.load_state_dict(state_dict)
            model.eval()
            if self.device.type == "cuda":
                model = model.to(memory_format=torch.channels_last)
        elif state_dict is not None:
            raise ValueError("pass state_dict or model, not both")
        self.model = model
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

    @property
    def outputs(self) -> list:
        return (["detections", "valid", "relevant_count"]
                if self.count_relevant else ["detections", "valid"])

    def settings(self) -> Dict:
        """postprocess's settings at the current thresholds."""
        return dict(num_classes=self.num_classes, conf_thre=self.conf_thre,
                    nms_thre=self.nms_thre, pre_nms_topk=self.pre_nms_topk,
                    max_dets=self.max_dets, topk_approx=self.topk_approx,
                    cat_cap=self.cat_cap,
                    return_relevant_count=self.count_relevant)

    def program(self) -> DetectionProgram:
        """The device program at the current thresholds, as a module."""
        return DetectionProgram(self.model, self.img_size, self.settings())

    @torch.inference_mode()
    def run_wire(self, flat: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """The device program on a planar wire device batch [B, 3*S*S].
        Returns device tensors (detections, valid[, relevant_count])."""
        return detection_program(self.model, flat, self.img_size,
                                 self.settings())

    @torch.inference_mode()
    def run(self, images: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """The device program on a uint8 NHWC device batch, through its
        NCHW view (channels-last already, so no layout copy): normalize,
        forward, decode, postprocess. The same function as ``run_wire``
        on the batch's planar wire."""
        return detection_forward(self.model, images.permute(0, 3, 1, 2),
                                 self.settings())

    def upload(self, images: np.ndarray) -> torch.Tensor:
        """Pad a uint8 NHWC host batch and copy it to the device."""
        if images.dtype != np.uint8:
            raise TypeError(f"images must be uint8 NHWC, got {images.dtype}")
        return upload_nhwc(images, self.batch_size, self.device)

    def dispatch(self, images: np.ndarray) -> Dispatched:
        """Upload and run without waiting, and enqueue the outputs' copies
        to the host: returns the ``Dispatched`` record for
        ``fetch_local``."""
        with device_scope(self.device):
            out = self.run(self.upload(images))
            return start_fetch(out, self.device)

    fetch_local = staticmethod(fetch_local)

    def warmup(self, dtype=np.uint8) -> None:
        """Run the program once on a zero batch (cuDNN picks its
        algorithms and the kernels are built); ``dtype``, the batcher's
        wire dtype, must be uint8."""
        self.fetch_local(self.dispatch(np.zeros(
            (self.batch_size, self.img_size, self.img_size, 3), dtype)))

    def __call__(self, images: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Synchronous predict. images: [B, S, S, 3] uint8, B <= batch_size.

        Returns (detections [B, max_dets, 7], valid [B, max_dets]) numpy,
        rows = x1, y1, x2, y2, obj, cls_conf, cls_idx in input pixels.
        """
        n = images.shape[0]
        dets, valid = self.fetch_local(self.dispatch(images))[:2]
        return dets[:n], valid[:n]
