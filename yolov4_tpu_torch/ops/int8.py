"""int8 convolution, s8 x s8 -> s32, for the quantized serving path
(``MODEL.QUANT`` int8 / int8_static).

The JAX package computes this product in XLA's ``conv_general_dilated``
with ``preferred_element_type=int32`` (yolov4_tpu/models/layers.py
``_quant_conv``), not in a Pallas kernel, so the port keeps it a library
product: on a CUDA tensor ``int8_conv`` runs ``torch._int_mm`` (cuBLASLt's
int8 tensor-core GEMM) on the NHWC activation viewed as a matrix, a 1x1
stride-1 conv directly on its ``[M, Ci]`` view and any other conv on an
explicit tap-gather im2col ``[M, kh*kw*Ci]`` of the padded tensor.
PyTorch has no int8 convolution on CUDA.

``_int_mm`` asks for more than 16 rows and for a contraction and an output
width that are multiples of 8: rows, taps and output channels are
zero-padded to that (the stem's 3x3x3 = 27 taps to 32), which adds
nothing to an integer sum. Any other refusal raises; nothing falls back
to a float conv.

``int8_conv_plain`` is the same function as a float64 ``F.conv2d`` of the
integer values, rounded to int32: exact, since every partial sum is an
integer far below 2^53 (at most 9 * 2048 * 127 * 128). CPU tensors take
it, and it is what the card's product is held to, bit for bit.

Layouts: activations NHWC int8 ``[B, H, W, Ci]``, weights OHWI int8
``[Co, kh, kw, Ci]``, outputs NHWC int32 ``[B, Ho, Wo, Co]``.
"""

from __future__ import annotations

import threading

import torch
import torch.nn.functional as F

# serving runs forwards in several host threads at once
_count_lock = threading.Lock()

# torch._int_mm's shape rules (aten/src/ATen/native/cuda/Blas.cpp)
MIN_ROWS = 17
ALIGN = 8


def _check(xq: torch.Tensor, wq: torch.Tensor) -> None:
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise TypeError(f"int8_conv takes int8 operands, got {xq.dtype} and "
                        f"{wq.dtype}")
    if xq.dim() != 4 or wq.dim() != 4 or xq.shape[-1] != wq.shape[-1]:
        raise ValueError(f"want NHWC x and OHWI w with the same Ci, got "
                         f"{tuple(xq.shape)} and {tuple(wq.shape)}")
    if xq.device != wq.device:
        raise ValueError(f"operands on {xq.device} and {wq.device}")


def out_size(size: int, k: int, stride: int, padding: int) -> int:
    return (size + 2 * padding - k) // stride + 1


def int8_conv_plain(xq: torch.Tensor, wq: torch.Tensor, stride: int = 1,
                    padding: int = 0, pad_value: int = 0) -> torch.Tensor:
    """The exact integer conv as a float64 convolution: x NHWC int8, w OHWI
    int8, each spatial border padded with ``pad_value`` (0, or -128 for the
    stem's shifted uint8 input); returns NHWC int32."""
    _check(xq, wq)
    x = xq.permute(0, 3, 1, 2).to(torch.float64)
    if padding:
        x = F.pad(x, (padding,) * 4, value=float(pad_value))
    w = wq.permute(0, 3, 1, 2).to(torch.float64)
    y = F.conv2d(x, w, stride=stride)
    return torch.round(y).to(torch.int32).permute(0, 2, 3, 1)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def im2col(xq: torch.Tensor, kh: int, kw: int, stride: int, padding: int,
           pad_value: int = 0, width: int = 0) -> torch.Tensor:
    """[B*Ho*Wo, max(kh*kw*Ci, width)] rows of x's taps in (dy, dx, ci)
    order (the OHWI weights' order), zero columns after them up to
    ``width``."""
    b, h, w, c = xq.shape
    ho, wo = (out_size(h, kh, stride, padding),
              out_size(w, kw, stride, padding))
    xp = (F.pad(xq, (0, 0, padding, padding, padding, padding),
                value=pad_value) if padding else xq)
    taps = [xp[:, dy:dy + stride * (ho - 1) + 1:stride,
               dx:dx + stride * (wo - 1) + 1:stride, :]
            for dy in range(kh) for dx in range(kw)]
    extra = width - kh * kw * c
    if extra > 0:
        taps.append(xq.new_zeros((b, ho, wo, extra)))
    return torch.cat(taps, dim=3).reshape(b * ho * wo, -1)


def int8_conv(xq: torch.Tensor, wq: torch.Tensor, stride: int = 1,
              padding: int = 0, pad_value: int = 0) -> torch.Tensor:
    """s8 x s8 -> s32 convolution: x NHWC int8 ``[B, H, W, Ci]``, w OHWI
    int8 ``[Co, kh, kw, Ci]``, borders padded with ``pad_value``; returns
    NHWC int32 ``[B, Ho, Wo, Co]``.

    On a CUDA tensor one ``torch._int_mm`` on the current stream, counted
    in ``int8_conv.launches``; on a CPU tensor ``int8_conv_plain``, not
    counted. Any other device raises."""
    _check(xq, wq)
    if xq.device.type == "cpu":
        return int8_conv_plain(xq, wq, stride, padding, pad_value)
    if xq.device.type != "cuda":
        raise ValueError(f"unsupported device {xq.device}")
    b, h, w, ci = xq.shape
    co, kh, kw, _ = wq.shape
    ho, wo = (out_size(h, kh, stride, padding),
              out_size(w, kw, stride, padding))
    k = kh * kw * ci
    kp, np_ = _round_up(k, ALIGN), _round_up(co, ALIGN)
    if kh == kw == 1 and stride == 1 and padding == 0 and kp == k:
        a = xq.contiguous().reshape(b * h * w, ci)
    else:
        a = im2col(xq, kh, kw, stride, padding, pad_value, width=kp)
    m = a.shape[0]
    if m < MIN_ROWS:
        a = F.pad(a, (0, 0, 0, MIN_ROWS - m))
    wt = wq.reshape(co, k)
    if kp != k or np_ != co:
        wt = F.pad(wt, (0, kp - k, 0, np_ - co))
    # the [Kp, Np] operand column-major (the transpose of a contiguous
    # [Np, Kp]): cuBLASLt's int8 GEMM takes it without a copy
    y = torch._int_mm(a, wt.t())
    if m < MIN_ROWS or np_ != co:
        y = y[:m, :co]
    with _count_lock:
        int8_conv.launches += 1
    return y.reshape(b, ho, wo, co)


int8_conv.launches = 0


def quantize_weights(wf: torch.Tensor):
    """Per-output-channel int8 quantization of a BN-folded float32 OIHW
    kernel (the JAX package's ``_quant_weights_folded``): ``sw =
    max(amax, 1e-12) / 127`` over each output channel, ``wq = round(wf /
    sw)``. Returns (wq int8 OHWI, sw float32 [Co])."""
    sw = torch.clamp(wf.abs().amax(dim=(1, 2, 3)), min=1e-12) / 127.0
    wq = torch.round(wf / sw[:, None, None, None]).to(torch.int8)
    return wq.permute(0, 2, 3, 1).contiguous(), sw


def activation_scale(amax: torch.Tensor) -> torch.Tensor:
    """The per-tensor activation scale ``max(amax, 1e-12) / 127``."""
    return torch.clamp(amax, min=1e-12) / 127.0


def quantize_activation(xf: torch.Tensor, sx: torch.Tensor) -> torch.Tensor:
    """``clip(round(x / sx), -127, 127)`` as int8, in x's layout."""
    return torch.round(xf / sx).clamp_(-127, 127).to(torch.int8)
