"""Detection heads (reference yolo/model/yolov4.py:227-268), NCHW.

Reproduces the reference's head asymmetry: the stride-8 head's output conv
is 3x3 while the stride-16/32 output convs are 1x1 (yolov4.py:237,243,249).
Output convs carry a bias and no BatchNorm. Anchor decoding lives in
models/decode.py.
"""

from __future__ import annotations

from torch import nn

from yolov4_tpu_torch.models.darknet import scale_channels
from yolov4_tpu_torch.models.layers import ConvBNAct


class Head(nn.Module):
    def __init__(self, c1: int, c2: int, c3: int, n_classes: int = 80,
                 n_anchors_per_scale: int = 3, width: float = 1.0):
        super().__init__()
        w = lambda ch: scale_channels(ch, width)
        out_ch = (4 + 1 + n_classes) * n_anchors_per_scale
        self.yolo1 = nn.Sequential(
            ConvBNAct(c1, w(256), 3, act="leaky_relu"),
            ConvBNAct(w(256), out_ch, 3, bias=True, bn=False, act="linear"))
        self.yolo2 = nn.Sequential(
            ConvBNAct(c2, w(512), 3, act="leaky_relu"),
            ConvBNAct(w(512), out_ch, 1, bias=True, bn=False, act="linear"))
        self.yolo3 = nn.Sequential(
            ConvBNAct(c3, w(1024), 3, act="leaky_relu"),
            ConvBNAct(w(1024), out_ch, 1, bias=True, bn=False, act="linear"))

    def forward(self, p1, p2, p3):
        return self.yolo1(p1), self.yolo2(p2), self.yolo3(p3)
