"""Eval-time CSP stage body with BatchNorm folded: the plain PyTorch version
of the kernel ``csrc/csp.cu`` and the weight folding both paths share.

The stage body is everything a CSP stage computes after its strided base
conv (reference darknet.py:84-138), with each ConvBNAct's BatchNorm folded
into its conv as a per-output-channel bias. ``cba`` is a conv + bias +
algebraic Mish:

  csp0 (stage 1, ``num_blocks`` = 0):
      a  = cba(x, part2_1_1)              1x1 C -> C
      t  = cba(a, part2_1_2_0)            1x1 C -> C/2
      s  = a + cba3(t, part2_1_2_1)       3x3 C/2 -> C
      x2 = cba(s, part2_2)                1x1 C -> C
      x1 = cba(x, part1)                  1x1 C -> C
      out = cba(concat(x2, x1), transition)    1x1 2C -> C

  csp (stages 2+, ``num_blocks`` >= 1):
      h  = cba(x, part2_0)                1x1 C -> C/2
      num_blocks x [h = h + cba3(cba(h, block{i}_0), block{i}_1)]
      x2 = cba(h, part2_2)                1x1 C/2 -> C/2
      x1 = cba(x, part1)                  1x1 C -> C/2
      out = cba(concat(x2, x1), transition)    1x1 C -> C

The function and its rounding points are those of the TPU kernel
``fused_csp_stage`` (yolov4_tpu/ops/csp_pallas.py:344): conv kernels in
x's dtype, sums, bias and Mish in float32; every ``cba`` output stored in
x's dtype except csp0's ``u`` (added to ``a`` in float32 before ``s`` is
cast) and ``x2``/``x1`` (concatenated in float32, then cast); csp's
residual add in x's dtype; the 3x3 convs zero-padded at image borders.

Layouts are the JAX package's: x is NHWC, a folded kernel is HWIO
``[k, k, ci, co]`` float32 and its bias ``[co]`` float32.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

Folded = Dict[str, Tuple[torch.Tensor, torch.Tensor]]


@torch.no_grad()
def fold_conv_bn(convbnact) -> Tuple[torch.Tensor, torch.Tensor]:
    """A bias-free ConvBNAct's eval-time (kernel [k, k, ci, co], bias [co]),
    float32: ``s = gamma * rsqrt(running_var + eps)``, kernel ``w * s``,
    bias ``beta - running_mean * s`` (the JAX package's ``FoldedConvBN``,
    models/layers.py:833-871). Folded in float32 whatever the module's
    parameter dtype."""
    conv, norm = convbnact.conv, convbnact.norm
    if norm is None or conv.bias is not None:
        raise ValueError("fold_conv_bn takes a bias-free conv followed by "
                         "BatchNorm")
    s = norm.weight.float() * torch.rsqrt(norm.running_var.float() + norm.eps)
    kernel = conv.weight.float().permute(2, 3, 1, 0) * s
    bias = norm.bias.float() - norm.running_mean.float() * s
    return kernel.contiguous(), bias


def stage_names(num_blocks: int) -> List[str]:
    """The folded-dict names of a stage body (csp_pallas.py:353-356)."""
    if num_blocks == 0:
        return ["part1", "part2_1_1", "part2_1_2_0", "part2_1_2_1",
                "part2_2", "transition"]
    names = ["part1", "part2_0"]
    for i in range(num_blocks):
        names += [f"block{i}_0", f"block{i}_1"]
    return names + ["part2_2", "transition"]


def _mish(x: torch.Tensor) -> torch.Tensor:
    e = torch.exp(torch.clamp(x, max=20.0))
    a = e * (e + 2.0)
    return torch.where(x > 20.0, x, x * a / (a + 2.0))


def _cba_f32(src: torch.Tensor, folded: Folded, name: str) -> torch.Tensor:
    """mish(conv(src) + bias) in float32 on an NHWC ``src``; the kernel is
    rounded to src's dtype first, as the TPU kernel feeds its dots."""
    kernel, bias = folded[name]
    w = kernel.to(src.dtype).float().permute(3, 2, 0, 1)     # OIHW
    y = F.conv2d(src.float().permute(0, 3, 1, 2), w,
                 padding=kernel.shape[0] // 2)
    return _mish(y.permute(0, 2, 3, 1) + bias.float())


def fused_csp_stage_plain(x: torch.Tensor, folded: Folded,
                          num_blocks: int) -> torch.Tensor:
    """The stage body on NHWC ``x`` [B, H, W, C] (float32 or bfloat16) ->
    [B, H, W, C] in x's dtype. ``folded``: name -> (kernel, bias) as
    :func:`fold_conv_bn` returns them, names from :func:`stage_names`."""
    dt = x.dtype

    def cba(src, name):
        return _cba_f32(src, folded, name).to(dt)

    if num_blocks == 0:
        a = cba(x, "part2_1_1")
        t = cba(a, "part2_1_2_0")
        s = (a.float() + _cba_f32(t, folded, "part2_1_2_1")).to(dt)
        x2 = _cba_f32(s, folded, "part2_2")
    else:
        h = cba(x, "part2_0")
        for i in range(num_blocks):
            p = cba(h, f"block{i}_0")
            h = h + cba(p, f"block{i}_1")
        x2 = _cba_f32(h, folded, "part2_2")
    x1 = _cba_f32(x, folded, "part1")
    return cba(torch.cat([x2, x1], dim=-1).to(dt), "transition")


def pack_weights(folded: Folded, num_blocks: int,
                 dtype: torch.dtype) -> List[torch.Tensor]:
    """The kernel's weight list: for each conv it launches, in launch
    order, a [K, N] matrix in ``dtype`` (K = k*k*ci, rows tap-major as
    HWIO flattens) and a [N] float32 bias. The two 1x1 convs that read x
    share one launch, their columns side by side: csp0 [part2_1_1 |
    part1] (N = 2C), csp [part2_0 | part1] (N = C)."""

    def mat(name):
        k = folded[name][0]
        return k.reshape(-1, k.shape[-1])

    first = ("part2_1_1" if num_blocks == 0 else "part2_0", "part1")
    out = [torch.cat([mat(n) for n in first], dim=1),
           torch.cat([folded[n][1] for n in first])]
    for name in stage_names(num_blocks)[2:]:
        out += [mat(name), folded[name][1]]
    return [t.to(dtype if i % 2 == 0 else torch.float32).contiguous()
            for i, t in enumerate(out)]
