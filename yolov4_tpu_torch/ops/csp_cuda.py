"""Eval-time CSP stage body: wrapper of the Hopper kernel ``csrc/csp.cu``.

The kernel replaces the TPU kernel ``fused_csp_stage``
(yolov4_tpu/ops/csp_pallas.py:344, bodies ``_csp0_kernel`` :236 and
``_csp_kernel`` :281); the source says what bounds it on an H100 and how
its design answers that. It is built from the package's own source at
first use (ops/cuda_build.py) and bound with ``ctypes``.

The stage body is the custom op ``torch.ops.yolov4_tpu_torch.
fused_csp_stage`` on x and the packed weights (ops/csp.pack_weights), so
that ``torch.export`` carries it into a serving artifact (utils/export.py):
its CUDA implementation launches the kernel, its CPU implementation is the
plain version on the weights read back from the float32 packed list
(ops/csp.unpack_weights, fused_csp_stage_plain), and its fake
implementation gives x's shape. A CUDA tensor launches the kernel or
raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import re
import threading
from pathlib import Path
from typing import List, Optional, Sequence

import torch

from yolov4_tpu_torch.ops.csp import (KERNEL_WIDTHS, Folded,
                                      fused_csp_stage_plain,
                                      kernel_gemm_shapes, kernel_widths,
                                      pack_weights, packed_dtype,
                                      unpack_weights)
from yolov4_tpu_torch.ops.cuda_build import (ARCH_FLAGS, COMMON_FLAGS,
                                             CSRC_DIR, build_library,
                                             ptxas_report)

SOURCE = CSRC_DIR / "csp.cu"
# -Xptxas -v: registers, shared memory and spills of each kernel, in the
# build log (cuda_build.build_library)
NVCC_FLAGS = (*ARCH_FLAGS, *COMMON_FLAGS, "-Xptxas", "-v")
DTYPES = (torch.float32, torch.bfloat16)

_lock = threading.Lock()
_lib = None
# serving assembles batches in several host threads at once
_count_lock = threading.Lock()


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
            lib.csp_conv_launches.argtypes = []
            lib.csp_conv_launches.restype = ctypes.c_longlong
            lib.csp_wgmma_smem.argtypes = [ctypes.c_int, ctypes.c_int]
            lib.csp_wgmma_smem.restype = ctypes.c_int
            _lib = lib
    return _lib


# the bfloat16 kernel's launch kinds, in csrc/csp.cu's order (wg::Kind)
KINDS = ("csp0_first", "csp0_last", "csp_first", "csp_mid", "csp_last")


def plan_kinds(num_blocks: int) -> list:
    """The launch kinds of ops/csp.launch_plan in bfloat16, in order."""
    if num_blocks == 0:
        return ["csp0_first", "csp0_last"]
    return ["csp_first"] + ["csp_mid"] * (num_blocks - 1) + ["csp_last"]


def kernel_report() -> list:
    """Each bfloat16 kernel instance as the build's ``-Xptxas -v`` reports
    it: launch kind, width CP, registers (ptxas' figure is the cap of the
    384-thread launch; setmaxnreg then gives the producer 64 and the
    consumers 216), stack and spill bytes, ptxas' performance notes (codes
    such as C7512, wgmma serialised), and the dynamic shared memory the
    launch asks for."""
    lib = _load()
    log = build().with_suffix(".log").read_text()
    name = re.compile(r"csp_wgmma_kernelILi(\d)ELi(\d+)E")
    notes = {}
    for line in log.splitlines():
        code, m = re.search(r"\((C\d+)\)", line), name.search(line)
        if code and m:
            notes.setdefault(m.groups(), []).append(code.group(1))
    rows = []
    for row in ptxas_report(log, "csp_wgmma_kernel"):
        m = name.search(row.pop("name"))
        row.pop("static_smem")  # the ring is dynamic shared memory
        kind, cp = int(m.group(1)), int(m.group(2))
        rows.append(dict(kind=KINDS[kind], cp=cp,
                         dynamic_smem=lib.csp_wgmma_smem(kind, cp),
                         notes=notes.get(m.groups(), []), **row))
    return rows


def conv_launches() -> int:
    """Conv kernel launches the library has enqueued since it was loaded
    (the launches of ops/csp.launch_plan in bfloat16)."""
    return int(_load().csp_conv_launches())


def fused_csp_supported(shape: Sequence[int], num_blocks: int,
                        dtype: torch.dtype) -> bool:
    """Whether the kernel takes an NHWC input of this shape and dtype for a
    stage body with ``num_blocks`` residual blocks (0 = csp0): any
    non-empty [B, H, W, C] with an even C, float32 or bfloat16; in
    bfloat16 C up to the widest compiled width (ops/csp.KERNEL_WIDTHS:
    128 for csp0, 256 otherwise, the widths of CSPDarknet53's stages 1-3
    at WIDTH 1). Shape logic only; the device is the caller's business."""
    if len(shape) != 4 or dtype not in DTYPES or num_blocks < 0:
        return False
    b, h, w, c = (int(s) for s in shape)
    if dtype == torch.bfloat16 and c > KERNEL_WIDTHS[min(num_blocks, 1)][-1]:
        return False
    return min(b, h, w) > 0 and c >= 2 and c % 2 == 0


def _weight_shapes(c: int, num_blocks: int, dtype: torch.dtype) -> list:
    """(weight shape, bias shape) of each packed GEMM, in launch order
    (ops/csp.pack_weights): float32 [K, N] and [N]; bfloat16 the flat
    chunked [K/64 * N * 64] and [N] at the padded widths."""
    if dtype == torch.bfloat16:
        return [((n * chunks * 64,), (n,))
                for n, chunks in kernel_gemm_shapes(c, num_blocks)]
    c2 = c // 2
    if num_blocks == 0:
        kn = [(c, 2 * c), (c, c2), (9 * c2, c), (c, c), (2 * c, c)]
    else:
        kn = ([(c, c)] + [(c2, c2), (9 * c2, c2)] * num_blocks
              + [(c2, c2), (c, c)])
    return [(s, s[1:]) for s in kn]


def _check_packed(packed, c, num_blocks, x) -> None:
    shapes = _weight_shapes(c, num_blocks, x.dtype)
    if len(packed) != 2 * len(shapes):
        raise ValueError(f"expected {2 * len(shapes)} packed tensors, got "
                         f"{len(packed)}")
    for i, (w_shape, b_shape) in enumerate(shapes):
        w, b = packed[2 * i], packed[2 * i + 1]
        for t, want, dt in ((w, w_shape, x.dtype),
                            (b, b_shape, torch.float32)):
            if (tuple(t.shape) != want or t.dtype != dt
                    or t.device != x.device or not t.is_contiguous()):
                raise ValueError(
                    f"packed weight {i}: want contiguous {dt} {want} on "
                    f"{x.device}, got {t.dtype} {tuple(t.shape)} on "
                    f"{t.device}")


def _check_input(x: torch.Tensor, num_blocks: int) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if not fused_csp_supported(x.shape, num_blocks, x.dtype):
        raise ValueError(f"the CSP kernel takes a non-empty NHWC float32 or "
                         f"bfloat16 input with an even C (bfloat16: C <= "
                         f"{KERNEL_WIDTHS[min(num_blocks, 1)][-1]}); got "
                         f"{x.dtype} {tuple(x.shape)}, "
                         f"num_blocks={num_blocks}")
    if not x.is_contiguous():
        raise ValueError("x must be a contiguous NHWC tensor")


@torch.library.custom_op("yolov4_tpu_torch::fused_csp_stage",
                         mutates_args=(), device_types="cpu")
def fused_csp_stage_op(x: torch.Tensor, packed: List[torch.Tensor],
                       num_blocks: int) -> torch.Tensor:
    """The op's CPU implementation: the plain version on the weights the
    packed list holds."""
    folded = unpack_weights(packed, x.shape[-1], num_blocks)
    return fused_csp_stage_plain(x, folded, num_blocks)


@fused_csp_stage_op.register_kernel("cuda")
def _fused_csp_stage_kernel(x: torch.Tensor, packed: List[torch.Tensor],
                            num_blocks: int) -> torch.Tensor:
    _check_input(x, num_blocks)
    b, h, w, c = x.shape
    _check_packed(packed, c, num_blocks, x)
    m = b * h * w
    if x.dtype == torch.bfloat16:     # P, then t or p0, then p1
        cp, c2p = kernel_widths(c, num_blocks)
        cols = ((2 * cp, c2p, 0) if num_blocks == 0 else (cp, c2p, c2p))
    else:                             # P, t, x2
        c2 = c // 2
        cols = ((2 * c, c2, c) if num_blocks == 0 else (c, c2, c2))
    scratch = [torch.empty((m, n), dtype=x.dtype, device=x.device)
               for n in cols]
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
    with _count_lock:
        fused_csp_stage_cuda.launches += 1
    return out


@fused_csp_stage_op.register_fake
def _fused_csp_stage_fake(x, packed, num_blocks):
    return torch.empty_like(x, memory_format=torch.contiguous_format)


def fused_csp_stage_cuda(x: torch.Tensor, folded: Folded, num_blocks: int,
                         packed: Optional[Sequence[torch.Tensor]] = None
                         ) -> torch.Tensor:
    """One CSP stage body (everything after the base conv) on NHWC ``x``
    [B, H, W, C], float32 or bfloat16; returns [B, H, W, C] in x's dtype:
    the custom op ``yolov4_tpu_torch::fused_csp_stage``.

    ``folded``: the stage's BN-folded weights (ops/csp.fold_conv_bn,
    names from ops/csp.stage_names). ``packed``: the same weights already
    packed on x's device (ops/csp.pack_weights with ops/csp.packed_dtype:
    the kernel's layout on a card, float32 on the CPU), so that a caller
    that keeps them skips the packing.

    On a CUDA tensor it enqueues the stage's conv kernels on the current
    stream (no synchronisation; in bfloat16 the launches of
    ops/csp.launch_plan) and adds one to ``fused_csp_stage_cuda.launches``;
    on a CPU tensor it returns the plain version and launches nothing.
    """
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    if packed is None:
        packed = [t.to(x.device) for t in pack_weights(folded, num_blocks,
                                                       packed_dtype(x))]
    return fused_csp_stage_op(x, list(packed), num_blocks)


fused_csp_stage_cuda.launches = 0
