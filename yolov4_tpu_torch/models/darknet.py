"""CSPDarknet53 detection backbone (reference yolo/model/yolov4.py:26-47),
returning the stride-8/16/32 pyramid levels. NCHW throughout."""

from __future__ import annotations

from typing import Tuple, Union

import torch
from torch import nn

from yolov4_tpu_torch.models.layers import (ConvBNAct, CSPDownSample,
                                            CSPDownSample0)


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
