"""Operations and bytes from shapes, and the H100's published peaks: the
yardstick of the per-layer metrics, frozen here so that a change to the
program cannot move it.

Copied from the program's tools: ``forward_conv_flops``
(yolov4_tpu_torch/tools/profile_train.py), ``k2_ops``, ``k2_bound`` and
``nms_bound`` (chip_smoke.py), over the reference model's conv shapes
instead of the program's modules.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from portbench import reference
from portbench.reference.model import conv_shapes

# NVIDIA H100 SXM data sheet, dense: bfloat16 tensor cores, float32
# outside them, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# float32 operations of K1's pair test (2 min, 2 max, 2 sub, 2 clamp, 1
# mul for the intersection; 1 add, 1 sub, 1 clamp for the union; 1 div,
# 1 compare) and of a box's area
NMS_OPS_PER_PAIR = 14
NMS_OPS_PER_BOX = 3


def forward_conv_flops(config: Dict, batch: int, size: int) -> float:
    """FLOPs (2 a multiply-add) of every conv of one forward of the
    configuration's reference model on [batch, 3, size, size]."""
    with torch.device("meta"):
        model = reference.build(config)
    return float(sum(2 * out * per for out, per in
                     conv_shapes(model, (batch, 3, size, size))))


def csp_stage_shapes(batch: int, size: int) -> List[Tuple[int, int, int,
                                                            int, int]]:
    """(B, H, W, C, num_blocks) of the bodies of CSPDarknet53's stages 1-3,
    the ones K2 runs: after each strided base conv."""
    return [(batch, size // 2, size // 2, 64, 0),
            (batch, size // 4, size // 4, 128, 2),
            (batch, size // 8, size // 8, 256, 8)]


def k2_conv_shapes(c: int, nb: int) -> Dict[str, Tuple[int, int, int]]:
    """(ci, co, k) of each conv of a stage body."""
    c2 = c // 2
    if nb == 0:
        return {"part1": (c, c, 1), "part2_1_1": (c, c, 1),
                "part2_1_2_0": (c, c2, 1), "part2_1_2_1": (c2, c, 3),
                "part2_2": (c, c, 1), "transition": (2 * c, c, 1)}
    out = {"part1": (c, c2, 1), "part2_0": (c, c2, 1)}
    for i in range(nb):
        out[f"block{i}_0"] = (c2, c2, 1)
        out[f"block{i}_1"] = (c2, c2, 3)
    out.update(part2_2=(c2, c2, 1), transition=(c, c, 1))
    return out


def k2_ops(b: int, h: int, w: int, c: int, nb: int) -> float:
    """Multiply-adds x 2 of every conv of a stage body at every pixel."""
    return 2.0 * b * h * w * sum(ci * co * k * k for ci, co, k in
                                 k2_conv_shapes(c, nb).values())


def k2_bound(b: int, h: int, w: int, c: int, nb: int,
             itemsize: int = 2) -> float:
    """Least seconds of one bfloat16 stage body: its operations over the
    bfloat16 peak against x and the output (``itemsize`` bytes each), the
    weights and the float32 biases moved once, whichever is longer."""
    shapes = k2_conv_shapes(c, nb).values()
    weight_bytes = sum(ci * co * k * k * itemsize + co * 4
                       for ci, co, k in shapes)
    nbytes = 2 * b * h * w * c * itemsize + weight_bytes
    return max(k2_ops(b, h, w, c, nb) / PEAK_BF16_FLOPS,
               nbytes / PEAK_BYTES)


def k2_forward_bound(batch: int, size: int) -> float:
    """K2's least seconds for one forward: its three stage bodies."""
    return sum(k2_bound(*s) for s in csp_stage_shapes(batch, size))


def nms_bound(b: int, k: int) -> float:
    """Least seconds of one keep mask of ``b`` images of ``k`` candidates:
    the pair test on every pair j < i and each box's area over the float32
    peak, against the boxes and valid flags read and the keep mask written
    once."""
    ops = NMS_OPS_PER_PAIR * b * k * (k - 1) / 2 + NMS_OPS_PER_BOX * b * k
    return max(ops / PEAK_F32_FLOPS, b * k * (16 + 1 + 1) / PEAK_BYTES)
