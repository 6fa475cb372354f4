"""Eval-mode BatchNorm and activation in one pass: the plain version.

``batch_norm_act_plain`` is the arithmetic of the Hopper kernel
``csrc/bn_act.cu`` (ops/bn_act_cuda.py) in plain PyTorch, step for step:
BN's per-channel terms from its own parameters and running statistics in
float32, ``x * scale + shift``, Mish by the port's algebraic formula
(``mish``, which models/layers.py's chain uses too) or leaky ReLU 0.1, all
in float32, then one rounding to x's dtype. It is the CPU implementation
of the custom op ``yolov4_tpu_torch::batch_norm_act`` and the anchor the
kernel is held against. ``models/layers.ConvBNAct`` runs its own BN and
activation on the CPU; this computes the same function with one rounding
fewer.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

ACTS = ("mish", "leaky_relu")


def bn_terms(weight: torch.Tensor, bias: torch.Tensor,
             running_mean: torch.Tensor, running_var: torch.Tensor,
             eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scale, shift), float32 [C]: scale = weight / sqrt(var + eps),
    shift = bias - mean * scale, each an IEEE float32 operation in the
    kernel's order."""
    scale = weight.float() * torch.sqrt(running_var.float() + eps).reciprocal()
    return scale, bias.float() - running_mean.float() * scale


def mish(x: torch.Tensor) -> torch.Tensor:
    """Mish, x * tanh(softplus(x)), through the exact algebraic identity
    tanh(ln(u)) = (u^2 - 1) / (u^2 + 1) with u = 1 + e^x:

        mish(x) = x * a / (a + 2),  a = e^x (e^x + 2)

    the same formula as the JAX package (one exp instead of three
    transcendentals). For x > 20, a / (a + 2) == 1 to ~1e-17: clamp to
    avoid exp overflow and return x, mish's exact asymptote. The port's
    Mish (models/layers.ACTIVATIONS) and the kernel's plain version.
    """
    e = torch.exp(torch.clamp(x, max=20.0))
    a = e * (e + 2.0)
    return torch.where(x > 20.0, x, x * a / (a + 2.0))


def batch_norm_act_plain(x: torch.Tensor, weight: torch.Tensor,
                         bias: torch.Tensor, running_mean: torch.Tensor,
                         running_var: torch.Tensor, eps: float,
                         act: str) -> torch.Tensor:
    """act(BN(x)) for NCHW ``x`` [N, C, H, W] (any strides) with BN's eval
    terms: float32 throughout, one rounding to x's dtype at the end. ``act``
    is "mish" or "leaky_relu". The output has x's shape, dtype and memory
    format."""
    if act not in ACTS:
        raise ValueError(f"act must be one of {ACTS}: {act!r}")
    scale, shift = bn_terms(weight, bias, running_mean, running_var, eps)
    v = x.float() * scale[:, None, None] + shift[:, None, None]
    out = mish(v) if act == "mish" else F.leaky_relu(v, negative_slope=0.1)
    return out.to(x.dtype)
