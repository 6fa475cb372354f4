"""Eval-time CSP stage body: wrapper of the Hopper kernel ``csrc/csp.cu``.

The kernel replaces the TPU kernel ``fused_csp_stage``
(yolov4_tpu/ops/csp_pallas.py:344, bodies ``_csp0_kernel`` :236 and
``_csp_kernel`` :281); the source says what bounds it on an H100 and how
its design answers that. It is built from the package's own source at
first use (ops/cuda_build.py) and bound with ``ctypes``.

A CPU tensor takes the plain version (ops/csp.fused_csp_stage_plain). A
CUDA tensor launches the kernel or raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Optional, Sequence

import torch

from yolov4_tpu_torch.ops.csp import (Folded, fused_csp_stage_plain,
                                      pack_weights)
from yolov4_tpu_torch.ops.cuda_build import (ARCH_FLAGS, COMMON_FLAGS,
                                             CSRC_DIR, build_library)

SOURCE = CSRC_DIR / "csp.cu"
NVCC_FLAGS = (*ARCH_FLAGS, *COMMON_FLAGS)
DTYPES = (torch.float32, torch.bfloat16)

_lock = threading.Lock()
_lib = None


def build() -> Path:
    """Compile ``csrc/csp.cu`` (once per source and flags); return the
    library's path. A failed build raises ``RuntimeError``."""
    return build_library(SOURCE, NVCC_FLAGS)


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.csp_stage.argtypes = (
                [ctypes.c_int] + [ctypes.c_void_p] * 7
                + [ctypes.c_int] * 5 + [ctypes.c_void_p])
            lib.csp_stage.restype = ctypes.c_int
            _lib = lib
    return _lib


def fused_csp_supported(shape: Sequence[int], num_blocks: int,
                        dtype: torch.dtype) -> bool:
    """Whether the kernel takes an NHWC input of this shape and dtype for a
    stage body with ``num_blocks`` residual blocks (0 = csp0): any
    non-empty [B, H, W, C] with an even C, float32 or bfloat16. Shape
    logic only; the device is the caller's business."""
    if len(shape) != 4 or dtype not in DTYPES or num_blocks < 0:
        return False
    b, h, w, c = (int(s) for s in shape)
    return min(b, h, w) > 0 and c >= 2 and c % 2 == 0


def _weight_shapes(c: int, num_blocks: int) -> list:
    """[K, N] of each packed weight, in launch order (ops/csp.pack_weights)."""
    c2 = c // 2
    if num_blocks == 0:
        return [(c, 2 * c), (c, c2), (9 * c2, c), (c, c), (2 * c, c)]
    return ([(c, c)] + [(c2, c2), (9 * c2, c2)] * num_blocks
            + [(c2, c2), (c, c)])


def _check_packed(packed, c, num_blocks, x) -> None:
    shapes = _weight_shapes(c, num_blocks)
    if len(packed) != 2 * len(shapes):
        raise ValueError(f"expected {2 * len(shapes)} packed tensors, got "
                         f"{len(packed)}")
    for i, kn in enumerate(shapes):
        w, b = packed[2 * i], packed[2 * i + 1]
        for t, want, dt in ((w, kn, x.dtype), (b, kn[1:], torch.float32)):
            if (tuple(t.shape) != want or t.dtype != dt
                    or t.device != x.device or not t.is_contiguous()):
                raise ValueError(
                    f"packed weight {i}: want contiguous {dt} {want} on "
                    f"{x.device}, got {t.dtype} {tuple(t.shape)} on "
                    f"{t.device}")


def fused_csp_stage_cuda(x: torch.Tensor, folded: Folded, num_blocks: int,
                         packed: Optional[Sequence[torch.Tensor]] = None
                         ) -> torch.Tensor:
    """One CSP stage body (everything after the base conv) on NHWC ``x``
    [B, H, W, C], float32 or bfloat16; returns [B, H, W, C] in x's dtype.

    ``folded``: the stage's BN-folded weights (ops/csp.fold_conv_bn,
    names from ops/csp.stage_names). ``packed``: the same weights already
    in the kernel's layout on x's device (ops/csp.pack_weights with x's
    dtype), so that a caller that keeps them skips the packing.

    On a CUDA tensor it enqueues the stage's conv kernels on the current
    stream (no synchronisation) and adds one to
    ``fused_csp_stage_cuda.launches``; on a CPU tensor it returns the plain
    version and launches nothing.
    """
    if x.device.type == "cpu":
        return fused_csp_stage_plain(x, folded, num_blocks)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if not fused_csp_supported(x.shape, num_blocks, x.dtype):
        raise ValueError(f"the CSP kernel takes a non-empty NHWC float32 or "
                         f"bfloat16 input with an even C; got {x.dtype} "
                         f"{tuple(x.shape)}, num_blocks={num_blocks}")
    if not x.is_contiguous():
        raise ValueError("x must be a contiguous NHWC tensor")
    b, h, w, c = x.shape
    if packed is None:
        packed = [t.to(x.device) for t in pack_weights(folded, num_blocks,
                                                       x.dtype)]
    _check_packed(packed, c, num_blocks, x)
    m, c2 = b * h * w, c // 2
    wide = 2 * c if num_blocks == 0 else c
    scratch = [torch.empty((m, cols), dtype=x.dtype, device=x.device)
               for cols in (wide, c2, c if num_blocks == 0 else c2)]
    out = torch.empty_like(x)
    n = len(packed) // 2
    w_ptrs = (ctypes.c_void_p * n)(*[t.data_ptr() for t in packed[0::2]])
    b_ptrs = (ctypes.c_void_p * n)(*[t.data_ptr() for t in packed[1::2]])
    lib = _load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.csp_stage(int(x.dtype == torch.bfloat16), x.data_ptr(),
                            out.data_ptr(), *[s.data_ptr() for s in scratch],
                            ctypes.addressof(w_ptrs), ctypes.addressof(b_ptrs),
                            b, h, w, c, num_blocks, stream)
    if err != 0:
        raise RuntimeError(f"csp_stage launch failed: CUDA error {err}")
    fused_csp_stage_cuda.launches += 1
    return out


fused_csp_stage_cuda.launches = 0

