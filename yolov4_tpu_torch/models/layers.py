"""Building-block layers (NCHW), the plain path of the JAX package's
models/layers.py: Mish, ConvBNAct, ResBlock, CSPDownSample0, CSPDownSample.

Module attribute names follow the reference torch tree (darknet/darknet.py:
14-138), so ``state_dict()`` keys are the reference's keys
(``part2_1_2.0.conv.weight``, ``part2.1.module_list.0.1.norm.running_var``)
and reference checkpoints load with plain ``load_state_dict``.

Initialisation (``init_weights``) matches reference yolov4.py:283-294:
conv kernels kaiming-normal (fan_out, relu gain), conv biases zero,
BatchNorm scale ~ N(0, 0.01^2), BatchNorm bias zero.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn


def mish(x: torch.Tensor) -> torch.Tensor:
    """Mish, x * tanh(softplus(x)), through the exact algebraic identity
    tanh(ln(u)) = (u^2 - 1) / (u^2 + 1) with u = 1 + e^x:

        mish(x) = x * a / (a + 2),  a = e^x (e^x + 2)

    the same formula as the JAX package (one exp instead of three
    transcendentals). For x > 20, a / (a + 2) == 1 to ~1e-17: clamp to
    avoid exp overflow and return x, mish's exact asymptote.
    """
    e = torch.exp(torch.clamp(x, max=20.0))
    a = e * (e + 2.0)
    return torch.where(x > 20.0, x, x * a / (a + 2.0))


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope=0.1)


ACTIVATIONS: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "relu": F.relu,
    "leaky_relu": leaky_relu,
    "mish": mish,
    "linear": lambda x: x,
}


class ConvBNAct(nn.Module):
    """Conv2d (symmetric ``(k-1)//2`` padding) + optional BatchNorm
    (eps 1e-5, momentum 0.1) + activation (reference darknet.py:23-58)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int,
                 stride: int = 1, bias: bool = False, bn: bool = True,
                 act: str = "leaky_relu"):
        super().__init__()
        if act not in ACTIVATIONS:
            raise ValueError(f"{act} does not support.")
        self.conv = nn.Conv2d(in_ch, out_ch, kernel_size, stride,
                              padding=(kernel_size - 1) // 2, bias=bias)
        self.norm = (nn.BatchNorm2d(out_ch, eps=1e-5, momentum=0.1)
                     if bn else None)
        self.act = ACTIVATIONS[act]

    @property
    def out_ch(self) -> int:
        return self.conv.out_channels

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.norm is not None:
            x = self.norm(x)
        return self.act(x)


class ResBlock(nn.Module):
    """num_blocks x [1x1 conv, 3x3 conv] with residual adds
    (reference darknet.py:61-81)."""

    def __init__(self, ch: int, num_blocks: int = 1, shortcut: bool = True,
                 act: str = "mish"):
        super().__init__()
        self.shortcut = shortcut
        self.module_list = nn.ModuleList(
            nn.Sequential(ConvBNAct(ch, ch, 1, act=act),
                          ConvBNAct(ch, ch, 3, act=act))
            for _ in range(num_blocks))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.module_list:
            h = block(x)
            x = x + h if self.shortcut else h
        return x


class CSPDownSample0(nn.Module):
    """First CSP stage with its non-standard split (reference
    darknet.py:84-113)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3,
                 stride: int = 2, act: str = "mish"):
        super().__init__()
        c = out_ch
        self.base = ConvBNAct(in_ch, c, kernel_size, stride, act=act)
        self.part1 = ConvBNAct(c, c, 1, act=act)
        self.part2_1_1 = ConvBNAct(c, c, 1, act=act)
        self.part2_1_2 = nn.Sequential(ConvBNAct(c, c // 2, 1, act=act),
                                       ConvBNAct(c // 2, c, 3, act=act))
        self.part2_2 = ConvBNAct(c, c, 1, act=act)
        self.transition = ConvBNAct(2 * c, c, 1, act=act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.base(x)
        x1 = self.part1(x)
        x2_1_1 = self.part2_1_1(x)
        x2 = self.part2_2(x2_1_1 + self.part2_1_2(x2_1_1))
        return self.transition(torch.cat([x2, x1], dim=1))


class CSPDownSample(nn.Module):
    """Generic CSP downsampling stage (reference darknet.py:116-138)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3,
                 stride: int = 2, num_blocks: int = 1, shortcut: bool = True,
                 act: str = "mish"):
        super().__init__()
        c, c2 = out_ch, out_ch // 2
        self.base = ConvBNAct(in_ch, c, kernel_size, stride, act=act)
        self.part1 = ConvBNAct(c, c2, 1, act=act)
        self.part2 = nn.Sequential(
            ConvBNAct(c, c2, 1, act=act),
            ResBlock(c2, num_blocks=num_blocks, shortcut=shortcut, act=act),
            ConvBNAct(c2, c2, 1, act=act))
        self.transition = ConvBNAct(2 * c2, c, 1, act=act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.base(x)
        x1 = self.part1(x)
        x2 = self.part2(x)
        return self.transition(torch.cat([x2, x1], dim=1))


@torch.no_grad()
def init_weights(module: nn.Module,
                 generator: Optional[torch.Generator] = None) -> None:
    """Reference init (yolov4.py:283-294), drawn from ``generator``: conv
    kernels kaiming-normal with fan_out and the relu gain, conv biases 0,
    BN scale ~ N(0, 0.01), BN bias 0, running stats mean 0 / var 1."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            nn.init.kaiming_normal_(m.weight, mode="fan_out",
                                    nonlinearity="relu", generator=generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, nn.BatchNorm2d):
            nn.init.normal_(m.weight, 0.0, 0.01, generator=generator)
            nn.init.zeros_(m.bias)
            m.reset_running_stats()
