"""Weights and inputs made from ``--seed``, on the device, in a few large
draws: the same seed gives the same tensors, handed alike to the program
and to the reference.

Weights follow a trained network's scale rather than the reference init
(whose BatchNorm scales of N(0, 0.01) leave every detection a tie):
convs Student-t with 4 degrees of freedom at variance 1 / fan_in (the
heavy tails of trained kernels, which per-channel int8 feels and a
normal draw hides), BatchNorm scale 0.5 + 0.1 N and shift 1 + 0.2 N,
so that most units work where Mish and leaky ReLU are near linear (with
a zero-mean shift the random network is chaotic: bfloat16 rounding alone
moves a median score by 0.13); the heads' output convs give raw maps
whose box, objectness and class channels spread, with an objectness bias
of -2 so that a minority of anchors score high. For detection each
BatchNorm's running statistics are then set from a calibration batch by
the reference model in float32 (reference.model.calibrate_bn), so that
every layer of the eval forward normalizes what it is given. The model
is the configuration's reference (portbench/reference/__init__.py), so a
new architecture keeps these rules where it keeps the names: its heads'
output convs ``head.<x>.1.conv``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from portbench import reference
from portbench.reference.train import tf32_off

# channel factors of a head output conv, per anchor: x, y, w, h, obj, cls
_HEAD_FACTORS = (1.5, 1.5, 0.6, 0.6, 3.0)
_CLS_FACTOR = 3.0
_OBJ_BIAS = -2.0


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for one stream of a seed (weights,
    inputs, ...): the streams of one seed never overlap."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) << 4) | stream)
    return g


def named_shapes(config: Dict, width: Optional[float] = None,
                 depth: Optional[float] = None):
    """(name, shape, dtype) of each entry of the configuration's reference
    ``state_dict``, at the file's width and depth unless given."""
    with torch.device("meta"):
        model = reference.build(config, width, depth)
    return [(n, tuple(t.shape), t.dtype) for n, t in
            model.state_dict().items()]


def _head_scale(shape, n_classes: int, device) -> torch.Tensor:
    per = torch.tensor(_HEAD_FACTORS + (_CLS_FACTOR,) * n_classes,
                       device=device)
    return per.repeat(shape[0] // (5 + n_classes)).reshape(-1, 1, 1, 1)


@torch.no_grad()
def make_weights(config: Dict, seed: int, device,
                 width: Optional[float] = None,
                 depth: Optional[float] = None) -> Dict[str, torch.Tensor]:
    """A state_dict (float32, on ``device``) in the reference's keys, which
    are the program's."""
    n_classes = int(config["n_classes"])
    shapes = named_shapes(config, width, depth)
    floats = [(n, s) for n, s, dt in shapes if dt.is_floating_point]
    total = sum(int(torch.Size(s).numel()) for _, s in floats)
    g = generator(seed, 0, device)
    noise = torch.randn(total, generator=g, device=device)
    # Student-t, 4 degrees of freedom, unit variance: z / sqrt(chi2_4 / 4)
    # / sqrt(2)
    chi = torch.randn((4, total), generator=g, device=device)
    heavy = noise * torch.rsqrt(chi.square_().mean(0) * 2.0)
    del chi
    out, pos = {}, 0
    for name, shape, dtype in shapes:
        if not dtype.is_floating_point:
            out[name] = torch.zeros(shape, dtype=dtype, device=device)
            continue
        n = int(torch.Size(shape).numel())
        z = noise[pos:pos + n].reshape(shape)
        zt = heavy[pos:pos + n].reshape(shape)
        pos += n
        leaf = name.rsplit(".", 1)[-1]
        if name.endswith("norm.weight"):
            t = 0.5 + 0.1 * z
        elif name.endswith("norm.bias"):
            t = 1.0 + 0.2 * z
        elif leaf == "running_mean":
            t = torch.zeros_like(z)
        elif leaf == "running_var":
            t = torch.ones_like(z)
        elif leaf == "weight":
            fan_in = int(torch.Size(shape[1:]).numel())
            if name.startswith("head.") and name.endswith(".1.conv.weight"):
                t = z / fan_in ** 0.5 * _head_scale(shape, n_classes, device)
            elif len(shape) == 4:
                t = zt / fan_in ** 0.5
            else:
                t = z / fan_in ** 0.5
        elif name.startswith("head.") and leaf == "bias":
            per = torch.zeros(5 + n_classes, device=device)
            per[4] = _OBJ_BIAS
            t = per.repeat(shape[0] // (5 + n_classes))
        else:
            t = torch.zeros_like(z)
        out[name] = t.contiguous()
    return out


@torch.no_grad()
def calibrate(config: Dict, state: Dict[str, torch.Tensor],
              images_u8: torch.Tensor, width: Optional[float] = None,
              depth: Optional[float] = None) -> None:
    """Set ``state``'s BatchNorm running statistics in place from the
    reference's float32 eval forward on uint8 NHWC ``images_u8``."""
    with torch.device("meta"):
        model = reference.build(config, width, depth)
    model = model.to_empty(device=images_u8.device)
    model.load_state_dict(state)
    with tf32_off():
        reference.module(config).calibrate_bn(
            model, images_u8.permute(0, 3, 1, 2).float() / 255.0)
    for name, t in model.state_dict().items():
        state[name].copy_(t)


def detect_pool(seed: int, pool: int, batch: int, size: int,
                device) -> torch.Tensor:
    """[pool, batch, size, size, 3] uint8 images, uniform noise."""
    return torch.randint(0, 256, (pool, batch, size, size, 3),
                         generator=generator(seed, 1, device),
                         device=device, dtype=torch.uint8)


def train_pool(seed: int, pool: int, batch: int, size: int, max_labels: int,
               boxes: Tuple[int, int], n_classes: int, device):
    """``pool`` detector batches: bfloat16 NHWC images in [0, 1) and
    [batch, max_labels, 5] labels (cx, cy, w, h, cls in pixels) with
    boxes[0] to boxes[1] boxes an image, each 5 % to 60 % of the side."""
    g = generator(seed, 2, device)
    shape = (pool, batch)
    images = torch.rand(shape + (size, size, 3), generator=g,
                        device=device).to(torch.bfloat16)
    count = torch.randint(boxes[0], boxes[1] + 1, shape, generator=g,
                          device=device)
    u = torch.rand(shape + (max_labels, 4), generator=g, device=device)
    wh = (0.05 + 0.55 * u[..., 2:4]) * size
    cxy = wh / 2 + u[..., 0:2] * (size - wh)
    cls = torch.randint(0, n_classes, shape + (max_labels, 1), generator=g,
                        device=device).float()
    labels = torch.cat([cxy, wh, cls], -1)
    rows = torch.arange(max_labels, device=device)
    labels = labels * (rows < count[..., None])[..., None]
    return images, labels


def classify_pool(seed: int, pool: int, batch: int, size: int,
                  n_classes: int, device):
    """``pool`` classifier batches: uint8 NHWC crops and int64 labels."""
    g = generator(seed, 3, device)
    images = torch.randint(0, 256, (pool, batch, size, size, 3),
                           generator=g, device=device, dtype=torch.uint8)
    labels = torch.randint(0, n_classes, (pool, batch), generator=g,
                           device=device)
    return images, labels
