"""Anchor decoding (reference yolo/model/yololayer.py:16-166) as functions
over NCHW head outputs.

For each scale l (strides 8/16/32) the raw head output [B, 3*(5+C), f, f]
is viewed as [B, 3, 5+C, f, f] (channel index a*(5+C)+k, anchor-major) and
moved to [B, 3, f, f, 5+C], then:

    bx = sigmoid(tx) + cx          bw = exp(tw) * anchor_w / stride
    by = sigmoid(ty) + cy          bh = exp(th) * anchor_h / stride
    obj/cls = sigmoid(raw)

Training returns per-layer (output, pred) pairs for the loss — ``output``
keeps RAW tw/th (only xy/obj/cls sigmoided), ``pred`` holds decoded
grid-unit boxes (yololayer.py:122-145). Eval scales decoded boxes by the
stride into input pixels and flattens anchor-major (yololayer.py:146-166).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

STRIDES: Tuple[int, int, int] = (8, 16, 32)


def masked_anchors(anchors: Sequence[Sequence[float]],
                   anchor_mask: Sequence[Sequence[int]],
                   layer_no: int) -> np.ndarray:
    """Per-layer anchors in grid units: anchors[mask] / stride
    (reference yololayer.py:73-76). Returns [n_anchors, 2] float32."""
    stride = STRIDES[layer_no]
    sel = [anchors[i] for i in anchor_mask[layer_no]]
    return np.asarray(sel, dtype=np.float32) / float(stride)


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float32, or as it is when its dtype is wider (float64): the
    decode, the loss and the train step's input follow a float64 run and
    compute everything narrower in float32."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def split_head_output(raw: torch.Tensor, n_anchors: int,
                      n_ch: int) -> torch.Tensor:
    """[B, A*n_ch, f_h, f_w] NCHW -> [B, A, f_h, f_w, n_ch], anchor-major
    (channel index c = a * n_ch + k, the reference's view)."""
    b, _, fh, fw = raw.shape
    return raw.reshape(b, n_anchors, n_ch, fh, fw).permute(0, 1, 3, 4, 2)


def decode_layer(raw: torch.Tensor, anchors_grid, layer_no: int,
                 training: bool):
    """Decode one scale.

    Args:
      raw: [B, A*(5+C), f_h, f_w] NCHW head output (pre-activation).
      anchors_grid: [A, 2] anchors already divided by the stride (a
        float32 tensor on raw's device is used without a copy).
      layer_no: 0/1/2 selecting stride 8/16/32.
      training: choose the train (dict) or eval (flat pixels) branch.

    Returns:
      training: dict(layer_no, output=[B,A,f,f,5+C] with raw wh,
                     pred=[B,A,f,f,4] decoded cxcywh in grid units)
      eval: [B, A*f_h*f_w, 5+C] float32 (float64 for a float64 raw),
            boxes in input pixels.
    """
    dt = torch.promote_types(raw.dtype, torch.float32)
    anc = torch.as_tensor(anchors_grid, device=raw.device).to(dt)
    n_anchors = anc.shape[0]
    n_ch = raw.shape[1] // n_anchors
    stride = STRIDES[layer_no]

    x = split_head_output(raw, n_anchors, n_ch).to(dt)  # [B, A, fh, fw, n_ch]
    b, _, fh, fw, _ = x.shape

    txy = torch.sigmoid(x[..., 0:2])
    twh = x[..., 2:4]
    objcls = torch.sigmoid(x[..., 4:])

    cy, cx = torch.meshgrid(
        torch.arange(fh, dtype=dt, device=raw.device),
        torch.arange(fw, dtype=dt, device=raw.device),
        indexing="ij")
    grid = torch.stack([cx, cy], dim=-1)  # [fh, fw, 2]

    box_xy = txy + grid
    box_wh = torch.exp(twh) * anc.reshape(1, n_anchors, 1, 1, 2)

    if training:
        output = torch.cat([txy, twh, objcls], dim=-1)
        pred = torch.cat([box_xy, box_wh], dim=-1)
        return {"layer_no": layer_no, "output": output, "pred": pred}

    boxes = torch.cat([box_xy, box_wh], dim=-1) * stride
    flat = torch.cat([boxes, objcls], dim=-1)
    return flat.reshape(b, n_anchors * fh * fw, n_ch)


def decode_all(raws: Sequence[torch.Tensor], anchors_grids: Sequence,
               training: bool):
    """Decode all three scales with their [A, 2] grid-unit anchors
    (``masked_anchors``). Training: list of per-layer dicts (order
    preserved). Eval: concatenated [B, sum_l A*f_l^2, 5+C]
    (reference yolov4.py:321-324)."""
    outs: List = [decode_layer(raw, anc, layer_no, training)
                  for layer_no, (raw, anc) in enumerate(zip(raws,
                                                            anchors_grids))]
    if training:
        return outs
    return torch.cat(outs, dim=1)
