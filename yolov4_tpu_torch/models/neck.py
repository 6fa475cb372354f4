"""SPP + FPN + PAN neck (reference yolo/model/yolov4.py:50-224), NCHW.

Keeps the reference's SPP pooling quirk: the published model computes
``m3 = max_pool1(x)`` (yolov4.py:70), so the effective pool sizes are
5/9/5 rather than the paper's 5/9/13 (``legacy_pools=True``, the default).
Upsampling is nearest-neighbour 2x.

Input channel counts are derived from the producing layers, so any width
multiplier gives the same topology as the JAX package's shape-inferring
convs.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from yolov4_tpu_torch.models.darknet import scale_channels
from yolov4_tpu_torch.models.decode import at_least_f32
from yolov4_tpu_torch.models.layers import ConvBNAct


def upsample2x_nearest(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample in NCHW via broadcast (no gather)."""
    b, c, h, w = x.shape
    x = x[:, :, :, None, :, None].expand(b, c, h, 2, w, 2)
    return x.reshape(b, c, h * 2, w * 2)


class _MaxPoolSplitTies(torch.autograd.Function):
    """Stride-1 same-padded max pooling whose backward SPLITS each window's
    gradient equally among its maximal positions: the JAX package's default
    ``maxpool_same`` VJP (models/neck.py:34-90). Ties are not rare under
    bfloat16. The forward is ``F.max_pool2d``."""

    @staticmethod
    def forward(ctx, x, size):
        y = F.max_pool2d(x, size, stride=1, padding=size // 2)
        ctx.save_for_backward(x, y)
        ctx.size = size
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        size = ctx.size
        pad = size // 2
        h, w = x.shape[2], x.shape[3]
        # ties per window: input positions equal to the window's max (the
        # -inf padding never equals one)
        xp = F.pad(x, (pad, pad, pad, pad), value=float("-inf"))
        cnt = None
        for dy in range(size):
            for dx in range(size):
                eq = (xp[:, :, dy:dy + h, dx:dx + w] == y).float()
                cnt = eq if cnt is None else cnt + eq
        gn = (at_least_f32(g) / cnt).to(g.dtype)
        # dL/dx[q] = sum over the windows p that hold q of
        # g[p] / ties[p] * [x[q] == y[p]]  (y padded with +inf, g with 0)
        yp = F.pad(y, (pad, pad, pad, pad), value=float("inf"))
        gp = F.pad(gn, (pad, pad, pad, pad))
        acc = None
        for dy in range(size):
            for dx in range(size):
                c = torch.where(x == yp[:, :, dy:dy + h, dx:dx + w],
                                gp[:, :, dy:dy + h, dx:dx + w],
                                torch.zeros((), dtype=g.dtype,
                                            device=g.device))
                acc = c if acc is None else acc + c
        return acc, None


def maxpool_same(x: torch.Tensor, size: int,
                 exact_grad: bool = False) -> torch.Tensor:
    """Stride-1 max pooling with same padding (torch MaxPool2d(k, 1, k//2),
    padding never wins a window). Its gradient splits among tied maxima,
    the JAX package's default; ``exact_grad`` (MODEL.EXACT_POOL_GRAD)
    routes each window's gradient to the first maximum in row-major order,
    torch's own backward and the JAX package's ``maxpool_same_exact``."""
    if exact_grad or not (torch.is_grad_enabled() and x.requires_grad):
        return F.max_pool2d(x, size, stride=1, padding=size // 2)
    return _MaxPoolSplitTies.apply(x, size)


def _chain(in_ch: int, spec, width: float) -> nn.Sequential:
    """Sequential of leaky ConvBNActs from ``spec`` = [(ch, k), ...]."""
    layers = []
    for ch, k in spec:
        out = scale_channels(ch, width)
        layers.append(ConvBNAct(in_ch, out, k, 1, act="leaky_relu"))
        in_ch = out
    return nn.Sequential(*layers)


_WIDE_256 = [(256, 1), (512, 3), (256, 1), (512, 3), (256, 1)]
_WIDE_128 = [(128, 1), (256, 3), (128, 1), (256, 3), (128, 1)]
_WIDE_512 = [(512, 1), (1024, 3), (512, 1), (1024, 3), (512, 1)]


class SPPBlock(nn.Module):
    """Spatial pyramid pooling (reference yolov4.py:50-74)."""

    def __init__(self, in_ch: int, width: float = 1.0,
                 legacy_pools: bool = True, exact_pool_grad: bool = False):
        super().__init__()
        w = lambda ch: scale_channels(ch, width)
        self.legacy_pools = legacy_pools
        self.exact_pool_grad = exact_pool_grad
        self.conv1 = nn.Sequential(
            ConvBNAct(in_ch, w(512), 1, act="leaky_relu"),
            ConvBNAct(w(512), w(1024), 3, act="leaky_relu"),
            ConvBNAct(w(1024), w(512), 1, act="leaky_relu"))
        self.conv2 = ConvBNAct(4 * w(512), w(512), 1, act="leaky_relu")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv1(x)
        exact = self.exact_pool_grad
        m1 = maxpool_same(x, 5, exact)
        m2 = maxpool_same(x, 9, exact)
        # reference quirk: third branch reuses pool size 5 (yolov4.py:70)
        m3 = maxpool_same(x, 5 if self.legacy_pools else 13, exact)
        return self.conv2(torch.cat([m3, m2, m1, x], dim=1))


class FPNBlock(nn.Module):
    """Top-down feature pyramid (reference yolov4.py:93-149)."""

    def __init__(self, c3: int, c4: int, c5: int, width: float = 1.0):
        super().__init__()
        w = lambda ch: scale_channels(ch, width)
        self.module1 = nn.Sequential(
            ConvBNAct(c5, w(1024), 3, act="leaky_relu"),
            ConvBNAct(w(1024), w(512), 1, act="leaky_relu"))
        self.conv3 = ConvBNAct(w(512), w(256), 1)
        self.conv4 = ConvBNAct(c4, w(256), 1, act="leaky_relu")
        self.module2 = _chain(2 * w(256), _WIDE_256, width)
        self.conv10 = ConvBNAct(w(256), w(128), 1)
        self.conv11 = ConvBNAct(c3, w(128), 1, act="leaky_relu")
        self.module3 = _chain(2 * w(128), _WIDE_128, width)

    def forward(self, x3, x4, x5):
        f3 = self.module1(x5)
        f2 = upsample2x_nearest(self.conv3(f3))
        f2 = self.module2(torch.cat([self.conv4(x4), f2], dim=1))
        f1 = upsample2x_nearest(self.conv10(f2))
        f1 = self.module3(torch.cat([self.conv11(x3), f1], dim=1))
        return f1, f2, f3


class PANBlock(nn.Module):
    """Bottom-up path aggregation (reference yolov4.py:152-191)."""

    def __init__(self, width: float = 1.0):
        super().__init__()
        w = lambda ch: scale_channels(ch, width)
        self.conv1 = ConvBNAct(w(128), w(256), 3, 2, act="leaky_relu")
        self.module1 = _chain(2 * w(256), _WIDE_256, width)
        self.conv7 = ConvBNAct(w(256), w(512), 3, 2, act="leaky_relu")
        self.module2 = _chain(2 * w(512), _WIDE_512, width)

    def forward(self, f1, f2, f3):
        p2 = self.module1(torch.cat([self.conv1(f1), f2], dim=1))
        p3 = self.module2(torch.cat([self.conv7(p2), f3], dim=1))
        return f1, p2, p3


class Neck(nn.Module):
    """SPP + FPN + PAN (reference yolov4.py:194-224)."""

    def __init__(self, c3: int, c4: int, c5: int, width: float = 1.0,
                 legacy_pools: bool = True, exact_pool_grad: bool = False):
        super().__init__()
        self.spp = SPPBlock(c5, width=width, legacy_pools=legacy_pools,
                            exact_pool_grad=exact_pool_grad)
        self.fpn = FPNBlock(c3, c4, self.spp.conv2.out_ch, width=width)
        self.pan = PANBlock(width=width)

    def forward(self, x3, x4, x5):
        f1, f2, f3 = self.fpn(x3, x4, self.spp(x5))
        return self.pan(f1, f2, f3)
