"""Greedy NMS keep mask: wrapper of the Hopper kernel ``csrc/nms.cu``.

The kernel replaces the TPU kernel ``greedy_nms_mask_pallas``
(yolov4_tpu/ops/nms_pallas.py:140-191, body ``_nms_kernel`` :37-136); the
source says what bounds it on an H100 and how its design answers that:
a triangular pair-mask launch, then a block-parallel scan over row blocks
of 64 fed from shared memory by bulk copies. ops/nms.py holds both halves
on the CPU (``pair_mask_words``, ``scan_mask_words``).

It is built from the package's own source at first use, with
``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false``
(ops/cuda_build.py), and bound with ``ctypes``.

The keep mask is the custom op ``torch.ops.yolov4_tpu_torch.
greedy_nms_mask``, so that ``torch.export`` carries it into a serving
artifact (utils/export.py): its CUDA implementation launches the kernel,
its CPU implementation is the plain version (ops/nms.greedy_nms_mask), and
its fake implementation gives the [B, K] bool shape. A CUDA tensor
launches the kernel or raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from yolov4_tpu_torch.ops.cuda_build import (ARCH_FLAGS, COMMON_FLAGS,
                                             CSRC_DIR, build_library,
                                             ptxas_report)
from yolov4_tpu_torch.ops.nms import greedy_nms_mask, n_words

SOURCE = CSRC_DIR / "nms.cu"
# -Xptxas -v: registers, shared memory and spills of each kernel, in the
# build log (cuda_build.build_library)
NVCC_FLAGS = (*ARCH_FLAGS, *COMMON_FLAGS, "-fmad=false", "-Xptxas", "-v")
# the removed-bitset of one image lives in the scan kernel's shared memory
MAX_K = 48 * 1024 * 8

_lock = threading.Lock()
_libs = {}
# serving assembles batches in several host threads at once
_count_lock = threading.Lock()


def build(flags=NVCC_FLAGS) -> Path:
    """Compile ``csrc/nms.cu`` (once per source and flags); return the
    library's path. A failed build raises ``RuntimeError``."""
    return build_library(SOURCE, flags)


def load(flags=NVCC_FLAGS) -> ctypes.CDLL:
    """The library built with ``flags``, its C entry points typed; built
    and loaded once per flags. Other flags than ``NVCC_FLAGS`` serve only
    to time a variant (tools/nms_ring_depth.py)."""
    flags = tuple(flags)
    with _lock:
        if flags not in _libs:
            lib = ctypes.CDLL(str(build(flags)))
            ptr, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            for name, args in (
                    ("nms_keep_mask", [ptr, ptr, ptr, ptr, i, i, f, ptr]),
                    ("nms_pair_mask", [ptr, ptr, i, i, f, ptr]),
                    ("nms_scan", [ptr, ptr, ptr, i, i, ptr]),
                    ("nms_scan_smem", [i]), ("nms_scan_slots", [i])):
                getattr(lib, name).argtypes = args
                getattr(lib, name).restype = i
            _libs[flags] = lib
    return _libs[flags]


def scan_slots(k: int, flags=NVCC_FLAGS) -> int:
    """Slabs in the scan's shared-memory ring at this K; 0 where the ring
    does not fit and the scan reads the mask rows from device memory."""
    return int(load(flags).nms_scan_slots(k))


def kernel_report(k: int = 2048) -> list:
    """Each K1 kernel as the build's ``-Xptxas -v`` reports it (registers,
    static shared memory, stack and spill bytes), with the scan's dynamic
    shared memory and ring depth at this K."""
    lib = load()
    rows = ptxas_report(build().with_suffix(".log").read_text(), "nms_")
    for row in rows:
        scan = "nms_scan_kernel" in row["name"]
        row["dynamic_smem"] = int(lib.nms_scan_smem(k)) if scan else 0
        if scan:
            row["staged"] = "ILb1E" in row["name"]
    return rows


def _check_boxes(boxes_xyxy: torch.Tensor) -> tuple:
    if boxes_xyxy.device.type != "cuda":
        raise ValueError(f"unsupported device {boxes_xyxy.device}")
    if boxes_xyxy.dim() != 3 or boxes_xyxy.shape[-1] != 4:
        raise ValueError(f"boxes must be [B, K, 4], got {tuple(boxes_xyxy.shape)}")
    b, k, _ = boxes_xyxy.shape
    if boxes_xyxy.dtype != torch.float32:
        raise TypeError(f"boxes must be float32, got {boxes_xyxy.dtype}")
    if k > MAX_K:
        raise ValueError(f"K={k} exceeds the kernel's limit {MAX_K}")
    boxes_xyxy = boxes_xyxy.contiguous()
    if boxes_xyxy.data_ptr() % 16:
        raise ValueError("boxes must be 16-byte aligned")
    return boxes_xyxy, b, k


def _check_valid(valid: torch.Tensor, b: int, k: int, device) -> torch.Tensor:
    if valid.dtype != torch.bool or tuple(valid.shape) != (b, k):
        raise TypeError(f"valid must be bool [{b}, {k}], got "
                        f"{valid.dtype} {tuple(valid.shape)}")
    if valid.device != device:
        raise ValueError("boxes and valid lie on different devices")
    return valid.contiguous()


def _mask_scratch(b: int, k: int, device) -> torch.Tensor:
    """The kernel's pair mask [B, 64 * n_words, n_words]: rows padded to
    whole row blocks, so that each block's rows are one 16-byte-aligned
    slab."""
    nw = n_words(k)
    return torch.empty((b, 64 * nw, nw), dtype=torch.int64, device=device)


def _call(fn, *args, flags=NVCC_FLAGS) -> None:
    stream = torch.cuda.current_stream(args[0].device).cuda_stream
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(args[0].device):
        err = getattr(load(flags), fn)(*ptrs, stream)
    if err != 0:
        raise RuntimeError(f"{fn} launch failed: CUDA error {err}")


@torch.library.custom_op("yolov4_tpu_torch::greedy_nms_mask",
                         mutates_args=(), device_types="cpu")
def greedy_nms_mask_op(boxes_xyxy: torch.Tensor, valid: torch.Tensor,
                       iou_thresh: float) -> torch.Tensor:
    """The op's CPU implementation: the plain version (copied, since it may
    return ``valid`` itself and an op's output must not alias an input)."""
    return greedy_nms_mask(boxes_xyxy, valid, iou_thresh).clone()


@greedy_nms_mask_op.register_kernel("cuda")
def _greedy_nms_mask_kernel(boxes_xyxy: torch.Tensor, valid: torch.Tensor,
                            iou_thresh: float) -> torch.Tensor:
    boxes_xyxy, b, k = _check_boxes(boxes_xyxy)
    valid = _check_valid(valid, b, k, boxes_xyxy.device)
    mask = _mask_scratch(b, k, boxes_xyxy.device)
    keep = torch.empty((b, k), dtype=torch.bool, device=boxes_xyxy.device)
    _call("nms_keep_mask", boxes_xyxy, valid, mask, keep, b, k,
          float(iou_thresh))
    with _count_lock:
        greedy_nms_mask_cuda.launches += 1
    return keep


@greedy_nms_mask_op.register_fake
def _greedy_nms_mask_fake(boxes_xyxy, valid, iou_thresh):
    return boxes_xyxy.new_empty(boxes_xyxy.shape[:2], dtype=torch.bool)


def greedy_nms_mask_cuda(boxes_xyxy: torch.Tensor, valid: torch.Tensor,
                         iou_thresh: float) -> torch.Tensor:
    """Drop-in for ops/nms.greedy_nms_mask, for any K up to ``MAX_K``:
    the custom op ``yolov4_tpu_torch::greedy_nms_mask``.

    boxes_xyxy: [B, K, 4] float32, score-sorted along K; valid: [B, K]
    bool on the same device. Returns keep [B, K] bool. On a CUDA tensor it
    launches the kernel on the current stream (no synchronisation) and adds
    one to ``greedy_nms_mask_cuda.launches``; on a CPU tensor it returns the
    plain version's mask and launches nothing.
    """
    if boxes_xyxy.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {boxes_xyxy.device}")
    return greedy_nms_mask_op(boxes_xyxy, valid, float(iou_thresh))


greedy_nms_mask_cuda.launches = 0


def pair_mask_words_cuda(boxes_xyxy: torch.Tensor,
                         iou_thresh: float) -> torch.Tensor:
    """The kernel's first launch alone, for timing and for holding it
    against ops/nms.pair_mask_words: the [B, 64 * n_words, n_words] pair
    mask, whose rows below K and words at or above the diagonal are
    written (the rest is left as allocated). The main path does not call
    it, and it adds nothing to the launch count."""
    boxes_xyxy, b, k = _check_boxes(boxes_xyxy)
    mask = _mask_scratch(b, k, boxes_xyxy.device)
    _call("nms_pair_mask", boxes_xyxy, mask, b, k, float(iou_thresh))
    return mask


def scan_mask_words_cuda(mask: torch.Tensor, valid: torch.Tensor,
                         flags=NVCC_FLAGS) -> torch.Tensor:
    """The kernel's second launch alone on a pair mask laid out as
    ``pair_mask_words_cuda`` returns it (the counterpart of
    ops/nms.scan_mask_words), from the library built with ``flags``; keep
    [B, K] bool. Not on the main path and not counted."""
    b, k = valid.shape
    nw = n_words(k)
    if (mask.device.type != "cuda" or mask.dtype != torch.int64
            or tuple(mask.shape) != (b, 64 * nw, nw)
            or not mask.is_contiguous()):
        raise ValueError(f"mask must be a contiguous CUDA int64 "
                         f"[{b}, {64 * nw}, {nw}], got {mask.dtype} "
                         f"{tuple(mask.shape)} on {mask.device}")
    valid = _check_valid(valid, b, k, mask.device)
    keep = torch.empty((b, k), dtype=torch.bool, device=valid.device)
    _call("nms_scan", mask, valid, keep, b, k, flags=flags)
    return keep
