"""Eval-mode BatchNorm and Mish / leaky ReLU in one pass: wrapper of the
Hopper kernel ``csrc/bn_act.cu``.

The kernel replaces no TPU kernel (XLA fuses BN and the activation into
the conv by itself); it replaces the eager passes that follow each eval
conv of ``models/layers.ConvBNAct`` on a card: BN's transform and Mish's
nine elementwise kernels, or leaky ReLU's one. The source says what bounds
it and how its design answers that. It is built from the package's own
source at first use, with ``nvcc -gencode arch=compute_90a,code=sm_90a -O3
-fmad=false`` (ops/cuda_build.py), and bound with ``ctypes``.

The pass is the custom op ``torch.ops.yolov4_tpu_torch.batch_norm_act``
on the conv's output and the BN's own parameters and running statistics,
so that ``torch.export`` carries it into a serving artifact
(utils/export.py): its CUDA implementation launches the kernel, its CPU
implementation is the plain version (ops/bn_act.batch_norm_act_plain), and
its fake implementation gives x's shape, dtype and strides. A CUDA tensor
launches the kernel or raises: there is no fallback.

The pass runs once per conv of every eval forward, and its enqueue is
host time on the detection path. So ConvBNAct's eager calls launch the
kernel straight from ``batch_norm_act_cuda``, whose routing predicate has
checked the arguments, and only a traced program or a direct call goes
through the op and its checks; and the op is registered through
``torch.library.Library`` rather than ``torch.library.custom_op``, whose
Python layer adds an aliasing check and an autograd kernel to every call.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch
from torch import nn

from yolov4_tpu_torch.ops.bn_act import ACTS, batch_norm_act_plain
from yolov4_tpu_torch.ops.cuda_build import (ARCH_FLAGS, COMMON_FLAGS,
                                             CSRC_DIR, build_library,
                                             ptxas_report)

SOURCE = CSRC_DIR / "bn_act.cu"
# -fmad=false: x * scale + shift is a multiply and an add, as in the plain
# version; -Xptxas -v: registers and spills, in the build log
NVCC_FLAGS = (*ARCH_FLAGS, *COMMON_FLAGS, "-fmad=false", "-Xptxas", "-v")
DTYPES = (torch.float32, torch.bfloat16)
_ACT_CODES = {name: i for i, name in enumerate(ACTS)}

_lock = threading.Lock()
_lib = None
# replicas and serving threads run forwards in several host threads at once
_count_lock = threading.Lock()


def build() -> Path:
    """Compile ``csrc/bn_act.cu`` (once per source and flags); return the
    library's path. A failed build raises ``RuntimeError``."""
    return build_library(SOURCE, NVCC_FLAGS)


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            ptr, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.bn_act.argtypes = [i, i, i, ptr, ptr, ptr, ptr, ptr, ptr,
                                   ctypes.c_float, ll, i, ll, i, ptr]
            lib.bn_act.restype = i
            _lib = lib
    return _lib


def kernel_report() -> list:
    """Each kernel instance as the build's ``-Xptxas -v`` reports it: name,
    registers, static shared memory, stack and spill bytes."""
    _load()
    return ptxas_report(build().with_suffix(".log").read_text(),
                        "batch_norm_act")


def _launch(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
            running_mean: torch.Tensor, running_var: torch.Tensor,
            eps: float, act: str) -> torch.Tensor:
    """Enqueue the kernel on x's current stream and return its output. The
    caller has checked the arguments (``_check``, or the routing predicate
    ``batch_norm_act_supported``): x is contiguous NCHW or else
    channels-last."""
    y = torch.empty_like(x)
    n = x.numel()
    if n == 0:
        return y
    dev = x.get_device()
    # channels-last unless contiguous NCHW; where both hold (H = W = 1, or
    # C = 1) the two index the same memory alike
    err = _load().bn_act(
        int(x.dtype == torch.bfloat16), _ACT_CODES[act],
        int(not x.is_contiguous()), x.data_ptr(), y.data_ptr(),
        weight.data_ptr(), bias.data_ptr(), running_mean.data_ptr(),
        running_var.data_ptr(), eps, n, x.shape[1], x.shape[2] * x.shape[3],
        dev, torch._C._cuda_getCurrentRawStream(dev))
    if err != 0:
        raise RuntimeError(f"bn_act launch failed: CUDA error {err}")
    with _count_lock:
        batch_norm_act_cuda.launches += 1
    return y


def _check(x, params, act) -> None:
    """Every argument the kernel reads, for a caller outside ConvBNAct
    (an exported program, a direct call of the op)."""
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in DTYPES or x.dim() != 4:
        raise ValueError(f"x must be a float32 or bfloat16 [N, C, H, W], "
                         f"got {x.dtype} {tuple(x.shape)}")
    if not (x.is_contiguous()
            or x.is_contiguous(memory_format=torch.channels_last)):
        raise ValueError("x must be contiguous NCHW or channels-last, got "
                         f"strides {x.stride()}")
    c = x.shape[1]
    for t in params:
        if (t.dtype != torch.float32 or t.shape != (c,)
                or t.device != x.device or not t.is_contiguous()):
            raise ValueError(f"BN terms must be contiguous float32 [{c}] on "
                             f"{x.device}, got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")
    if act not in _ACT_CODES:
        raise ValueError(f"act must be one of {ACTS}: {act!r}")


_lib_def = torch.library.Library("yolov4_tpu_torch", "FRAGMENT")
_lib_def.define(
    "batch_norm_act(Tensor x, Tensor weight, Tensor bias, "
    "Tensor running_mean, Tensor running_var, float eps, str act) -> Tensor")


def _batch_norm_act_kernel(x: torch.Tensor, weight: torch.Tensor,
                           bias: torch.Tensor, running_mean: torch.Tensor,
                           running_var: torch.Tensor, eps: float,
                           act: str) -> torch.Tensor:
    _check(x, (weight, bias, running_mean, running_var), act)
    return _launch(x, weight, bias, running_mean, running_var, eps, act)


_lib_def.impl("batch_norm_act", _batch_norm_act_kernel, "CUDA")
# the CPU implementation is the plain version
_lib_def.impl("batch_norm_act", batch_norm_act_plain, "CPU")


@torch.library.register_fake("yolov4_tpu_torch::batch_norm_act",
                             lib=_lib_def)
def _batch_norm_act_fake(x, weight, bias, running_mean, running_var, eps,
                         act):
    return torch.empty_like(x)


batch_norm_act_op = torch.ops.yolov4_tpu_torch.batch_norm_act.default


def batch_norm_act_supported(x: torch.Tensor, norm: nn.BatchNorm2d) -> bool:
    """Whether the kernel takes NCHW ``x`` with ``norm``'s eval terms: a
    float32 or bfloat16 [N, C, H, W], contiguous or channels-last, and a
    BN with float32 running statistics and affine terms. Shape logic only;
    the device is the caller's business."""
    return (x.dtype in DTYPES and x.dim() == 4
            and (x.is_contiguous()
                 or x.is_contiguous(memory_format=torch.channels_last))
            and norm.running_var is not None and norm.weight is not None
            and norm.running_var.dtype == torch.float32
            and norm.weight.dtype == torch.float32)


def batch_norm_act_cuda(x: torch.Tensor, norm: nn.BatchNorm2d,
                        act: str) -> torch.Tensor:
    """act(norm(x)) for an eval ``norm`` (its running statistics), in one
    pass. ``act`` is "mish" or "leaky_relu"; ``batch_norm_act_supported(x,
    norm)`` holds. Returns a new tensor of x's shape, dtype and memory
    format.

    On an eager CUDA tensor it enqueues one kernel on the current stream
    (no synchronisation) and adds one to ``batch_norm_act_cuda.launches``,
    without the op's dispatch and checks (models/layers.ConvBNAct calls it
    once per conv of every eval forward, and its enqueue is host time on
    the detection path); a traced tensor (``torch.export``'s fake tensors)
    records the custom op ``yolov4_tpu_torch::batch_norm_act``, and a CPU
    tensor returns its plain version.
    """
    if type(x) is torch.Tensor and x.is_cuda:
        return _launch(x, norm.weight, norm.bias, norm.running_mean,
                       norm.running_var, norm.eps, act)
    return batch_norm_act_op(x, norm.weight, norm.bias, norm.running_mean,
                             norm.running_var, norm.eps, act)


batch_norm_act_cuda.launches = 0
