"""CSPDarknet53: the detection backbone (reference yolo/model/yolov4.py:
26-47), returning the stride-8/16/32 pyramid levels, and the ImageNet
classifier on it (reference darknet/darknet.py:141-193). NCHW
throughout."""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch
from torch import nn

from yolov4_tpu_torch.models.layers import (ConvBNAct, CSPDownSample,
                                            CSPDownSample0, init_weights)


def scale_channels(ch: int, width: float) -> int:
    """Width-multiplier channel scaling: nearest multiple of 8, floor 8
    (keeps every internal c//2 split even)."""
    if width == 1.0:
        return ch
    return max(8, int(round(ch * width / 8)) * 8)


def scale_blocks(n: int, depth: float) -> int:
    """Depth-multiplier residual-block scaling, floor 1."""
    if depth == 1.0:
        return n
    return max(1, int(round(n * depth)))


class Backbone(nn.Module):
    """CSPDarknet53 trunk. ``width``/``depth`` scale channel and
    residual-block counts (1.0 = the reference architecture; smaller values
    give topology-identical reduced variants for tests).

    ``pallas_csp`` (``MODEL.PALLAS_CSP``): False, True or "auto" (on for
    CUDA tensors). When on, the eval forward of stages 1-3 runs their
    bodies through K2 with BN folded (layers._CSPStage); stages 4 and 5
    stay on the layer-by-layer path, as in the JAX package. The same
    function and the same state_dict either way."""

    def __init__(self, width: float = 1.0, depth: float = 1.0,
                 pallas_csp: Union[bool, str] = False):
        super().__init__()
        w = lambda ch: scale_channels(ch, width)
        nb = lambda n: scale_blocks(n, depth)
        self.stem = ConvBNAct(3, w(32), 3, 1, act="mish")
        self.stage1 = CSPDownSample0(w(32), w(64), 3, 2, act="mish",
                                     fused=pallas_csp)
        self.stage2 = CSPDownSample(w(64), w(128), 3, 2, num_blocks=nb(2),
                                    fused=pallas_csp)
        self.stage3 = CSPDownSample(w(128), w(256), 3, 2, num_blocks=nb(8),
                                    fused=pallas_csp)
        self.stage4 = CSPDownSample(w(256), w(512), 3, 2, num_blocks=nb(8))
        self.stage5 = CSPDownSample(w(512), w(1024), 3, 2, num_blocks=nb(4))

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        x = self.stage2(self.stage1(self.stem(x)))
        x3 = self.stage3(x)
        x4 = self.stage4(x3)
        x5 = self.stage5(x4)
        return x3, x4, x5


# the standard deviation of a unit normal truncated to [-2, 2]: flax's
# truncated-normal initialisers divide by it so that the draws keep the
# asked-for variance
_TRUNC_NORMAL_STD = 0.87962566103423978


@torch.no_grad()
def lecun_normal_(weight: torch.Tensor,
                  generator: Optional[torch.Generator] = None) -> None:
    """flax's ``lecun_normal`` on a torch ``[out, in]`` Linear weight:
    a normal truncated at two standard deviations, variance 1 / fan_in."""
    std = math.sqrt(1.0 / weight.shape[1]) / _TRUNC_NORMAL_STD
    nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)


class CSPDarknet53(nn.Module):
    """ImageNet classifier: ``backbone`` (the detector's, with the same
    state_dict keys, so its weights load as MODEL.BACKBONE_PRETRAINED),
    then a global average pool and the Linear ``classifier`` (the JAX
    package's models/darknet.py CSPDarknet53). Logits ``[B,
    num_classes]`` from an NCHW float input.

    The backbone takes the reference init and the classifier flax's
    (lecun-normal weight, zero bias), drawn from ``generator`` (seed 0 when
    None). ``s2d`` and ``wpack`` are the JAX package's TPU lowerings, the
    same function as the plain path: accepted and ignored."""

    def __init__(self, num_classes: int = 1000, width: float = 1.0,
                 depth: float = 1.0, s2d=None, wpack=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        del s2d, wpack
        self.backbone = Backbone(width=width, depth=depth)
        self.classifier = nn.Linear(scale_channels(1024, width), num_classes)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        init_weights(self.backbone, generator)
        lecun_normal_(self.classifier.weight, generator)
        nn.init.zeros_(self.classifier.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x5 = self.backbone(x)[2]
        return self.classifier(x5.mean(dim=(2, 3)))
