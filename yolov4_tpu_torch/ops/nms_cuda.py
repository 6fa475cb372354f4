"""Greedy NMS keep mask: wrapper of the Hopper kernel ``csrc/nms.cu``.

The kernel replaces the TPU kernel ``greedy_nms_mask_pallas``
(yolov4_tpu/ops/nms_pallas.py:140-191, body ``_nms_kernel`` :37-136); the
source says what bounds it on an H100 and how its design answers that.

It is built from the package's own source at first use, with
``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false``, into
``yolov4_tpu_torch/_build/`` under a name keyed by a hash of the source and
the flags, and bound with ``ctypes`` (a plain C interface, so the build
takes seconds and needs no PyTorch headers).

A CPU tensor takes the plain version (ops/nms.greedy_nms_mask). A CUDA
tensor launches the kernel or raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from yolov4_tpu_torch.ops.nms import greedy_nms_mask

_PKG_DIR = Path(__file__).resolve().parent.parent
SOURCE = _PKG_DIR / "csrc" / "nms.cu"
BUILD_DIR = _PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")
# the removed-bitset of one image lives in the scan kernel's shared memory
MAX_K = 48 * 1024 * 8

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(cuda_home, "bin", "nvcc")


def build() -> Path:
    """Compile ``csrc/nms.cu`` into the build directory unless a library
    for this source and these flags is already there; return its path.
    A failed build raises ``RuntimeError`` with the compiler's output."""
    src = SOURCE.read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"libnms_{key}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}"
                           f"\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.nms_keep_mask.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                ctypes.c_void_p]
            lib.nms_keep_mask.restype = ctypes.c_int
            _lib = lib
    return _lib


def greedy_nms_mask_cuda(boxes_xyxy: torch.Tensor, valid: torch.Tensor,
                         iou_thresh: float) -> torch.Tensor:
    """Drop-in for ops/nms.greedy_nms_mask, for any K.

    boxes_xyxy: [B, K, 4] float32, score-sorted along K; valid: [B, K]
    bool on the same device. Returns keep [B, K] bool. On a CUDA tensor it
    launches the kernel on the current stream (no synchronisation) and adds
    one to ``greedy_nms_mask_cuda.launches``; on a CPU tensor it returns the
    plain version's mask and launches nothing.
    """
    if boxes_xyxy.device.type == "cpu":
        return greedy_nms_mask(boxes_xyxy, valid, iou_thresh)
    if boxes_xyxy.device.type != "cuda":
        raise ValueError(f"unsupported device {boxes_xyxy.device}")
    if boxes_xyxy.dim() != 3 or boxes_xyxy.shape[-1] != 4:
        raise ValueError(f"boxes must be [B, K, 4], got {tuple(boxes_xyxy.shape)}")
    b, k, _ = boxes_xyxy.shape
    if boxes_xyxy.dtype != torch.float32:
        raise TypeError(f"boxes must be float32, got {boxes_xyxy.dtype}")
    if valid.dtype != torch.bool or tuple(valid.shape) != (b, k):
        raise TypeError(f"valid must be bool [{b}, {k}], got "
                        f"{valid.dtype} {tuple(valid.shape)}")
    if valid.device != boxes_xyxy.device:
        raise ValueError("boxes and valid lie on different devices")
    if k > MAX_K:
        raise ValueError(f"K={k} exceeds the kernel's limit {MAX_K}")
    boxes_xyxy = boxes_xyxy.contiguous()
    valid = valid.contiguous()
    if boxes_xyxy.data_ptr() % 16:
        raise ValueError("boxes must be 16-byte aligned")
    n_words = (k + 63) // 64
    dev = boxes_xyxy.device
    mask = torch.empty((b, k, n_words), dtype=torch.int64, device=dev)
    keep = torch.empty((b, k), dtype=torch.bool, device=dev)
    lib = _load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.nms_keep_mask(boxes_xyxy.data_ptr(), valid.data_ptr(),
                                mask.data_ptr(), keep.data_ptr(), b, k,
                                float(iou_thresh), stream)
    if err != 0:
        raise RuntimeError(f"nms_keep_mask launch failed: CUDA error {err}")
    greedy_nms_mask_cuda.launches += 1
    return keep


greedy_nms_mask_cuda.launches = 0
