"""YOLOv4 and the CSPDarknet53 classifier in plain PyTorch, float32.

A frozen copy of the architecture the program implements (zjykzj/YOLOv4
yolo/model/yolov4.py and darknet/darknet.py; Bochkovskiy et al.,
arXiv:2004.10934): CSPDarknet53, SPP (with the reference's 5/9/5 pool
quirk), FPN, PAN, three heads, the anchor decode. Module attribute names
follow the reference torch tree, so a ``state_dict`` made for one side
loads into the other.

No fused kernel, no int8, no folding: every conv is ``F.conv2d`` and every
BatchNorm ``F.batch_norm``. Mish is ``F.mish`` (x tanh(softplus(x))).
In train mode BatchNorm normalizes with the batch's statistics and keeps
no running statistics; in eval mode it reads the running ones.
``calibrate_bn`` sets each BatchNorm's running statistics from the batch
it sees (the benchmark's weight maker uses it).

``precision(model, "fp8")`` makes every conv round its input and weight
to float8 e4m3 (per-tensor scaled) and the gradient of its output to
float8 e5m2, computing in float32 otherwise: the control one precision
below the program's bfloat16.

The module meets the reference contract (portbench/reference/__init__.py):
``build``, ``calibrate_bn``, ``precision``, ``model_input``, ``loss``. A
reference module of another architecture imports its layers from here.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

STRIDES = (8, 16, 32)
ANCHORS = ((12, 16), (19, 36), (40, 28), (36, 75), (76, 55), (72, 146),
           (142, 110), (192, 243), (459, 401))
ANCHOR_MASK = ((0, 1, 2), (3, 4, 5), (6, 7, 8))

# largest finite values of the two float8 formats
_FP8_MAX = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}

IMAGENET_MEAN = (0.485 * 255.0, 0.456 * 255.0, 0.406 * 255.0)
IMAGENET_STD = (0.229 * 255.0, 0.224 * 255.0, 0.225 * 255.0)


def fp8_round(x: torch.Tensor, dtype=torch.float8_e4m3fn) -> torch.Tensor:
    """``x`` rounded to float8 with one scale per tensor (its abs-max onto
    the format's largest value), back in x's dtype."""
    amax = x.detach().abs().amax().float().clamp(min=1e-30)
    scale = _FP8_MAX[dtype] / amax
    return ((x.float() * scale).to(dtype).float() / scale).to(x.dtype)


class _Fp8Conv(torch.autograd.Function):
    """conv2d on float8-rounded input and weight; the output's gradient is
    rounded to float8 e5m2 before the two backward products."""

    @staticmethod
    def forward(ctx, x, w, stride, padding):
        xq, wq = fp8_round(x), fp8_round(w)
        ctx.save_for_backward(xq, wq)
        ctx.stride, ctx.padding = stride, padding
        return F.conv2d(xq, wq, None, stride, padding)

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        gq = fp8_round(g, torch.float8_e5m2)
        gx = torch.nn.grad.conv2d_input(xq.shape, wq, gq, ctx.stride,
                                        ctx.padding)
        gw = torch.nn.grad.conv2d_weight(xq, wq.shape, gq, ctx.stride,
                                         ctx.padding)
        return gx, gw, None, None


class Norm(nn.Module):
    """BatchNorm (eps 1e-5) with the ``nn.BatchNorm2d`` state_dict keys."""

    def __init__(self, ch: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))
        self.register_buffer("running_mean", torch.zeros(ch))
        self.register_buffer("running_var", torch.ones(ch))
        self.register_buffer("num_batches_tracked",
                             torch.zeros((), dtype=torch.long))
        self.calibrating = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.calibrating:
            with torch.no_grad():
                self.running_mean.copy_(x.mean(dim=(0, 2, 3)))
                self.running_var.copy_(x.var(dim=(0, 2, 3), unbiased=False))
        if self.training:
            return F.batch_norm(x, None, None, self.weight, self.bias, True,
                                0.0, 1e-5)
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, False, 0.0, 1e-5)


_ACTS = {"mish": F.mish, "leaky_relu": lambda x: F.leaky_relu(x, 0.1),
         "linear": lambda x: x}


class ConvBNAct(nn.Module):
    def __init__(self, in_ch, out_ch, k, stride=1, bias=False, bn=True,
                 act="leaky_relu"):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, k, stride, (k - 1) // 2,
                              bias=bias)
        self.norm = Norm(out_ch) if bn else None
        self.act = _ACTS[act]
        self.fp8 = False

    @property
    def out_ch(self) -> int:
        return self.conv.out_channels

    def forward(self, x):
        conv = self.conv
        if self.fp8:
            x = _Fp8Conv.apply(x, conv.weight, conv.stride, conv.padding)
            if conv.bias is not None:
                x = x + conv.bias[:, None, None]
        else:
            x = conv(x)
        if self.norm is not None:
            x = self.norm(x)
        return self.act(x)


class ResBlock(nn.Module):
    def __init__(self, ch, num_blocks):
        super().__init__()
        self.module_list = nn.ModuleList(
            nn.Sequential(ConvBNAct(ch, ch, 1, act="mish"),
                          ConvBNAct(ch, ch, 3, act="mish"))
            for _ in range(num_blocks))

    def forward(self, x):
        for block in self.module_list:
            x = x + block(x)
        return x


class CSPDownSample0(nn.Module):
    def __init__(self, in_ch, c):
        super().__init__()
        self.base = ConvBNAct(in_ch, c, 3, 2, act="mish")
        self.part1 = ConvBNAct(c, c, 1, act="mish")
        self.part2_1_1 = ConvBNAct(c, c, 1, act="mish")
        self.part2_1_2 = nn.Sequential(ConvBNAct(c, c // 2, 1, act="mish"),
                                       ConvBNAct(c // 2, c, 3, act="mish"))
        self.part2_2 = ConvBNAct(c, c, 1, act="mish")
        self.transition = ConvBNAct(2 * c, c, 1, act="mish")

    def forward(self, x):
        x = self.base(x)
        x1 = self.part1(x)
        a = self.part2_1_1(x)
        x2 = self.part2_2(a + self.part2_1_2(a))
        return self.transition(torch.cat([x2, x1], dim=1))


class CSPDownSample(nn.Module):
    def __init__(self, in_ch, c, num_blocks):
        super().__init__()
        c2 = c // 2
        self.base = ConvBNAct(in_ch, c, 3, 2, act="mish")
        self.part1 = ConvBNAct(c, c2, 1, act="mish")
        self.part2 = nn.Sequential(ConvBNAct(c, c2, 1, act="mish"),
                                   ResBlock(c2, num_blocks),
                                   ConvBNAct(c2, c2, 1, act="mish"))
        self.transition = ConvBNAct(2 * c2, c, 1, act="mish")

    def forward(self, x):
        x = self.base(x)
        return self.transition(torch.cat([self.part2(x), self.part1(x)],
                                         dim=1))


def _w(ch: int, width: float) -> int:
    """The program's width multiplier (1.0 on the benchmark's cells; the
    CPU tests run 0.25): nearest multiple of 8, at least 8."""
    return ch if width == 1.0 else max(8, int(round(ch * width / 8)) * 8)


def _d(n: int, depth: float) -> int:
    return n if depth == 1.0 else max(1, int(round(n * depth)))


class Backbone(nn.Module):
    def __init__(self, width=1.0, depth=1.0):
        super().__init__()
        w = lambda c: _w(c, width)
        self.stem = ConvBNAct(3, w(32), 3, 1, act="mish")
        self.stage1 = CSPDownSample0(w(32), w(64))
        self.stage2 = CSPDownSample(w(64), w(128), _d(2, depth))
        self.stage3 = CSPDownSample(w(128), w(256), _d(8, depth))
        self.stage4 = CSPDownSample(w(256), w(512), _d(8, depth))
        self.stage5 = CSPDownSample(w(512), w(1024), _d(4, depth))

    def stages(self) -> List[nn.Module]:
        return [self.stem, self.stage1, self.stage2, self.stage3,
                self.stage4, self.stage5]

    def forward(self, x):
        x = self.stage2(self.stage1(self.stem(x)))
        x3 = self.stage3(x)
        x4 = self.stage4(x3)
        return x3, x4, self.stage5(x4)


def _chain(in_ch, spec, width):
    layers = []
    for ch, k in spec:
        layers.append(ConvBNAct(in_ch, _w(ch, width), k))
        in_ch = _w(ch, width)
    return nn.Sequential(*layers)


def _pool(x, k):
    return F.max_pool2d(x, k, 1, k // 2)


def _up2(x):
    return F.interpolate(x, scale_factor=2, mode="nearest")


class SPPBlock(nn.Module):
    def __init__(self, in_ch, width):
        super().__init__()
        w = lambda c: _w(c, width)
        self.conv1 = nn.Sequential(ConvBNAct(in_ch, w(512), 1),
                                   ConvBNAct(w(512), w(1024), 3),
                                   ConvBNAct(w(1024), w(512), 1))
        self.conv2 = ConvBNAct(4 * w(512), w(512), 1)

    def forward(self, x):
        x = self.conv1(x)
        # the reference's third branch reuses pool size 5 (yolov4.py:70)
        return self.conv2(torch.cat([_pool(x, 5), _pool(x, 9), _pool(x, 5),
                                     x], dim=1))


_W256 = [(256, 1), (512, 3), (256, 1), (512, 3), (256, 1)]
_W128 = [(128, 1), (256, 3), (128, 1), (256, 3), (128, 1)]
_W512 = [(512, 1), (1024, 3), (512, 1), (1024, 3), (512, 1)]


class FPNBlock(nn.Module):
    def __init__(self, c3, c4, c5, width):
        super().__init__()
        w = lambda c: _w(c, width)
        self.module1 = nn.Sequential(ConvBNAct(c5, w(1024), 3),
                                     ConvBNAct(w(1024), w(512), 1))
        self.conv3 = ConvBNAct(w(512), w(256), 1)
        self.conv4 = ConvBNAct(c4, w(256), 1)
        self.module2 = _chain(2 * w(256), _W256, width)
        self.conv10 = ConvBNAct(w(256), w(128), 1)
        self.conv11 = ConvBNAct(c3, w(128), 1)
        self.module3 = _chain(2 * w(128), _W128, width)

    def forward(self, x3, x4, x5):
        f3 = self.module1(x5)
        f2 = self.module2(torch.cat([self.conv4(x4), _up2(self.conv3(f3))],
                                    dim=1))
        f1 = self.module3(torch.cat([self.conv11(x3),
                                     _up2(self.conv10(f2))], dim=1))
        return f1, f2, f3


class PANBlock(nn.Module):
    def __init__(self, width):
        super().__init__()
        w = lambda c: _w(c, width)
        self.conv1 = ConvBNAct(w(128), w(256), 3, 2)
        self.module1 = _chain(2 * w(256), _W256, width)
        self.conv7 = ConvBNAct(w(256), w(512), 3, 2)
        self.module2 = _chain(2 * w(512), _W512, width)

    def forward(self, f1, f2, f3):
        p2 = self.module1(torch.cat([self.conv1(f1), f2], dim=1))
        p3 = self.module2(torch.cat([self.conv7(p2), f3], dim=1))
        return f1, p2, p3


class Neck(nn.Module):
    def __init__(self, c3, c4, c5, width):
        super().__init__()
        self.spp = SPPBlock(c5, width)
        self.fpn = FPNBlock(c3, c4, self.spp.conv2.out_ch, width)
        self.pan = PANBlock(width)

    def forward(self, x3, x4, x5):
        return self.pan(*self.fpn(x3, x4, self.spp(x5)))


class Head(nn.Module):
    def __init__(self, c1, c2, c3, n_classes, width):
        super().__init__()
        w = lambda c: _w(c, width)
        out = 3 * (5 + n_classes)
        lin = dict(bias=True, bn=False, act="linear")
        # the stride-8 output conv is 3x3, the others 1x1 (yolov4.py:237)
        self.yolo1 = nn.Sequential(ConvBNAct(c1, w(256), 3),
                                   ConvBNAct(w(256), out, 3, **lin))
        self.yolo2 = nn.Sequential(ConvBNAct(c2, w(512), 3),
                                   ConvBNAct(w(512), out, 1, **lin))
        self.yolo3 = nn.Sequential(ConvBNAct(c3, w(1024), 3),
                                   ConvBNAct(w(1024), out, 1, **lin))

    def forward(self, p1, p2, p3):
        return self.yolo1(p1), self.yolo2(p2), self.yolo3(p3)


def layer_anchors(layer_no: int) -> np.ndarray:
    """[3, 2] anchors of one scale in grid units."""
    return (np.asarray([ANCHORS[i] for i in ANCHOR_MASK[layer_no]],
                       np.float32) / STRIDES[layer_no])


def decode(raw: torch.Tensor, layer_no: int, training: bool):
    """One scale's head map [B, 3 (5+C), f, f] -> eval: [B, 3 f f, 5+C]
    (cx, cy, w, h in input pixels, sigmoid obj and classes); train: the
    loss's dict (xy and obj/cls sigmoided, raw wh; decoded grid boxes)."""
    b, ch, fh, fw = raw.shape
    n = ch // 3
    x = raw.float().reshape(b, 3, n, fh, fw).permute(0, 1, 3, 4, 2)
    anc = torch.from_numpy(layer_anchors(layer_no)).to(x.device)
    cy, cx = torch.meshgrid(torch.arange(fh, device=x.device,
                                         dtype=x.dtype),
                            torch.arange(fw, device=x.device, dtype=x.dtype),
                            indexing="ij")
    txy = torch.sigmoid(x[..., 0:2])
    objcls = torch.sigmoid(x[..., 4:])
    xy = txy + torch.stack([cx, cy], -1)
    wh = torch.exp(x[..., 2:4]) * anc.reshape(1, 3, 1, 1, 2)
    if training:
        return {"layer_no": layer_no,
                "output": torch.cat([txy, x[..., 2:4], objcls], -1),
                "pred": torch.cat([xy, wh], -1)}
    flat = torch.cat([torch.cat([xy, wh], -1) * STRIDES[layer_no], objcls],
                     -1)
    return flat.reshape(b, 3 * fh * fw, n)


class YOLOv4(nn.Module):
    """x: [B, 3, H, W] float in [0, 1]. Eval: [B, N, 5+C] decoded; train:
    three dicts for the loss."""

    def __init__(self, n_classes=80, width=1.0, depth=1.0):
        super().__init__()
        self.backbone = Backbone(width, depth)
        bb = self.backbone
        c3, c4, c5 = (bb.stage3.transition.out_ch,
                      bb.stage4.transition.out_ch,
                      bb.stage5.transition.out_ch)
        self.neck = Neck(c3, c4, c5, width)
        self.head = Head(self.neck.fpn.module3[-1].out_ch,
                         self.neck.pan.module1[-1].out_ch,
                         self.neck.pan.module2[-1].out_ch, n_classes, width)
        self.checkpointed = False

    def _run(self, fn, *args):
        if self.checkpointed and torch.is_grad_enabled():
            return torch.utils.checkpoint.checkpoint(fn, *args,
                                                     use_reentrant=False)
        return fn(*args)

    def forward(self, x):
        bb = self.backbone
        for stage in bb.stages()[:3]:
            x = self._run(stage, x)
        x3 = self._run(bb.stage3, x)
        x4 = self._run(bb.stage4, x3)
        x5 = self._run(bb.stage5, x4)
        p = self._run(self.neck, x3, x4, x5)
        raws = self._run(self.head, *p)
        outs = [decode(r, i, self.training) for i, r in enumerate(raws)]
        return outs if self.training else torch.cat(outs, 1)


class CSPDarknet53(nn.Module):
    """The ImageNet classifier: the backbone, a global average pool and a
    Linear (darknet/darknet.py:141-193)."""

    def __init__(self, num_classes=1000, width=1.0, depth=1.0):
        super().__init__()
        self.backbone = Backbone(width, depth)
        self.classifier = nn.Linear(_w(1024, width), num_classes)
        self.checkpointed = False

    def forward(self, x):
        for stage in self.backbone.stages():
            if self.checkpointed and torch.is_grad_enabled():
                x = torch.utils.checkpoint.checkpoint(stage, x,
                                                      use_reentrant=False)
            else:
                x = stage(x)
        return self.classifier(x.mean(dim=(2, 3)))


def build(kind: str, n_classes: int, width: float = 1.0,
          depth: float = 1.0) -> nn.Module:
    """The reference model of a configuration's ``model`` kind."""
    if kind == "yolov4":
        return YOLOv4(n_classes, width, depth)
    if kind == "cspdarknet53":
        return CSPDarknet53(n_classes, width, depth)
    raise ValueError(f"no reference model {kind!r}")


def model_input(kind: str, images: torch.Tensor) -> torch.Tensor:
    """NHWC batch -> NCHW float32: the detector takes images in [0, 1] as
    they are, the classifier uint8 normalized by the ImageNet statistics."""
    if kind == "cspdarknet53":
        mean = torch.tensor(IMAGENET_MEAN, device=images.device)
        std = torch.tensor(IMAGENET_STD, device=images.device)
        return ((images.float() - mean) / std).permute(0, 3, 1, 2)
    return images.float().permute(0, 3, 1, 2)


def loss(kind: str, out, labels: torch.Tensor) -> torch.Tensor:
    """The train step's loss of the train-mode output: the YOLO loss for
    the detector, the smoothed cross-entropy for the classifier."""
    # imported here: loss.py takes the anchors from this module
    from portbench.reference.loss import smoothed_ce, yolo_loss
    if kind == "yolov4":
        return yolo_loss(out, labels)
    return smoothed_ce(out, labels)


def precision(model: nn.Module, mode: str) -> nn.Module:
    """"float32" (the reference) or "fp8" (the control)."""
    if mode not in ("float32", "fp8"):
        raise ValueError(f"precision {mode!r}")
    for m in model.modules():
        if isinstance(m, ConvBNAct):
            m.fp8 = mode == "fp8"
    return model


@torch.no_grad()
def calibrate_bn(model: nn.Module, x: torch.Tensor) -> None:
    """One eval forward on ``x`` in which every BatchNorm first sets its
    running mean and (biased) variance to those of its input, so that each
    normalizes to unit scale what a batch like ``x`` gives it."""
    norms = [m for m in model.modules() if isinstance(m, Norm)]
    model.eval()
    for m in norms:
        m.calibrating = True
    try:
        model(x)
    finally:
        for m in norms:
            m.calibrating = False


def conv_shapes(model: nn.Module, x_shape: Sequence[int]) -> list:
    """(out numel, k*k*in/groups) of every conv of one forward, from a run
    on the meta device: no arithmetic is done."""
    rows = []

    def hook(mod, _inp, out):
        k = mod.kernel_size[0] * mod.kernel_size[1]
        rows.append((out.numel(), k * mod.in_channels // mod.groups))

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, nn.Conv2d)]
    try:
        with torch.no_grad():
            model.eval()(torch.empty(x_shape, device="meta"))
    finally:
        for h in handles:
            h.remove()
    return rows
