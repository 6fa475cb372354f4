"""On-device train augmentation (``AUGMENTATION.DEVICE``): the port's copy
of the JAX package's data/device_aug.py, in plain PyTorch.

The host only decodes each mosaic member's JPEG and stretch-resizes it to
an S x S canvas (``CanvasTransform``). The train step then applies, per
sample, on the canvases' device:

  random crop / zoom-out with channel-mean padding  (crop_and_pad)
  horizontal flip, gated by normal > 0.5            (about 31 %)
  HSV dithering (hue shift, saturation/exposure scaling)
  4-image mosaic; the reference's paste-window shifts are folded into
  each member's crop resample                       (blend_mosaic)
  box transforms on fixed [K, 5] rows, the mosaic's valid rows moved to
  the front in order and cut to ``max_labels``     (filter_truth)

The JAX package maps one sample at a time over the batch and loops over its
four members; here every step runs batched over the B x 4 members. The
crop and resize of a member is one separable linear resample (the
triangle kernel without antialiasing, the weights of JAX's
``scale_and_translate``, see :func:`resample_weights`), applied as two
batched float32 matrix products with TF32 off.

:func:`sample_params` draws all randomness from an explicit
``torch.Generator`` on the device; :func:`apply_params` is the rest and is
deterministic, so that the tests and the card can hold it against the JAX
package with given parameters. The draws have the JAX package's
distributions, not its values (Philox here, threefry there), and like the
JAX package's they are not the host pipeline's draw for draw.

Shapes are static: canvases [B, 4, S, S, 3] uint8 and member boxes
[B, 4, K, 5] float32 (x1, y1, x2, y2, cls in canvas pixels, zero rows are
padding) in; images [B, S, S, 3] float32 in [0, 1] and labels
[B, max_labels, 5] (cx, cy, w, h, cls) out.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, Optional, Tuple

import numpy as np
import torch

Params = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# colour space (cv2's float32 RGB <-> HSV, H in [0, 360))

def rgb_to_hsv(rgb: torch.Tensor) -> torch.Tensor:
    r, g, b = rgb.unbind(-1)
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    delta = maxc - minc
    zero = rgb.new_zeros(())
    s = torch.where(maxc > 0, delta / torch.clamp(maxc, min=1e-12), zero)
    safe = torch.clamp(delta, min=1e-12)
    h = torch.where(maxc == r, (g - b) / safe,
                    torch.where(maxc == g, 2.0 + (b - r) / safe,
                                4.0 + (r - g) / safe))
    # jnp's % on floats is the floor modulo: torch.remainder, not fmod
    h = torch.where(delta > 0, torch.remainder(h * 60.0, 360.0), zero)
    return torch.stack([h, s, maxc], dim=-1)


def hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    h, s, v = hsv.unbind(-1)
    h = torch.remainder(h, 360.0) / 60.0
    i = torch.floor(h)
    f = h - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    sector = torch.remainder(i.to(torch.int32), 6)

    def select(*by_sector):
        out = by_sector[5]
        for k in range(4, -1, -1):
            out = torch.where(sector == k, by_sector[k], out)
        return out

    return torch.stack([select(v, q, p, p, t, v), select(t, v, v, q, p, p),
                        select(p, p, t, v, v, q)], dim=-1)


# ---------------------------------------------------------------------------
# randomness

def sample_params(generator: torch.Generator, b: int, size: int,
                  jitter: float = 0.3, hue: float = 0.1,
                  saturation: float = 1.5, exposure: float = 1.5,
                  min_offset: float = 0.2, flip: bool = True,
                  dither: bool = True) -> Params:
    """All randomness of B mosaic samples (4 members each), drawn from
    ``generator`` on its device (the JAX package's ``_sample_params`` /
    ``_rand_scale``):

      crop    [B, 4, 4] int64, left/right/top/bottom offsets in canvas
              pixels, uniform on [-j, j] with j = round(S * jitter)
      flip    [B, 4] bool, normal > 0.5, and ``flip``
      dhue    [B, 4] uniform on [-hue, hue)
      dsat, dexp  [B, 4] uniform on [1, s), inverted with p = 0.5
      cut_x, cut_y  [B] int64, uniform on [int(S * min_offset),
              int(S * (1 - min_offset))]
      dither  [B, 4] bool, ``dither``
    """
    dev = generator.device
    j = int(round(size * jitter))
    lo, hi = int(size * min_offset), int(size * (1 - min_offset))

    def uniform(lo_, hi_):
        u = torch.rand((b, 4), generator=generator, device=dev)
        return u * (hi_ - lo_) + lo_

    def rand_scale(s):
        scale = uniform(1.0, s)
        inv = torch.rand((b, 4), generator=generator, device=dev) < 0.5
        return torch.where(inv, scale, 1.0 / scale)

    crop = torch.randint(-j, j + 1, (b, 4, 4), generator=generator,
                         device=dev)
    flips = torch.randn((b, 4), generator=generator, device=dev) > 0.5
    return {
        "crop": crop,
        "flip": flips & bool(flip),
        "dhue": uniform(-hue, hue),
        "dsat": rand_scale(saturation),
        "dexp": rand_scale(exposure),
        "cut_x": torch.randint(lo, hi + 1, (b,), generator=generator,
                               device=dev),
        "cut_y": torch.randint(lo, hi + 1, (b,), generator=generator,
                               device=dev),
        "dither": torch.full((b, 4), bool(dither), device=dev),
    }


# ---------------------------------------------------------------------------
# the deterministic half

def resample_weights(in_size: int, out_size: int, scale: torch.Tensor,
                     translation: torch.Tensor) -> torch.Tensor:
    """[N, in_size, out_size] weights of a linear resample with scale and
    translation [N] (output pixel o samples input coordinate
    ``(o + 0.5 - t) / s - 0.5``): JAX's ``compute_weight_mat`` with the
    triangle kernel and no antialiasing. Columns are divided by their sum
    where that exceeds 1000 float32 epsilons, and zeroed where the sample
    lies outside [-0.5, in_size - 0.5] (so out-of-range taps read 0)."""
    dt, dev = scale.dtype, scale.device
    inv_scale = (1.0 / scale)[:, None]
    o = torch.arange(out_size, dtype=dt, device=dev)
    sample_f = ((o + 0.5) * inv_scale - translation[:, None] * inv_scale
                - 0.5)                                          # [N, out]
    i = torch.arange(in_size, dtype=dt, device=dev)
    weights = torch.clamp(1.0 - torch.abs(sample_f[:, None, :]
                                          - i[None, :, None]), min=0.0)
    total = weights.sum(dim=1, keepdim=True)
    zero = weights.new_zeros(())
    weights = torch.where(
        torch.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
        weights / torch.where(total != 0, total, torch.ones_like(total)),
        zero)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[:, None, :], weights, zero)


@contextmanager
def _full_float32_matmul(device: torch.device):
    """TF32 off for the resample's products (scale_and_translate runs at
    HIGHEST precision), and no autocast around them."""
    with torch.autocast(device.type, enabled=False):
        if device.type != "cuda":
            yield
            return
        flag = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = flag


def _clip_boxes(boxes, x1, y1, x2, y2):
    """(rows, valid): the rows of ``boxes`` replaced by (x1, y1, x2, y2,
    cls), zeroed where the row was padding or the new box is empty."""
    valid = (boxes.sum(dim=-1) > 0) & (x1 < x2) & (y1 < y2)
    new = torch.stack([x1, y1, x2, y2, boxes[..., 4]], dim=-1)
    return torch.where(valid[..., None], new, new.new_zeros(())), valid


def _crop(imgs: torch.Tensor, boxes: torch.Tensor, crop: torch.Tensor,
          size: int, shift: Tuple[torch.Tensor, torch.Tensor]):
    """Jittered crop, channel-mean pad and resize back to S x S of N
    members (the JAX package's ``_crop_one``, batched).

    imgs [N, S, S, 3] float32, boxes [N, K, 5], crop [N, 4] (left, right,
    top, bottom; negative offsets zoom out), shift = (ty [N], tx [N]), an
    extra output-space translation (the mosaic's paste-window shift).
    Output pixel x samples input u = l + (x + 0.5 - tx) * crop_w / S - 0.5;
    the mean fill outside the canvas comes from linearity:
    resample(img - mean) + mean, the resample reading 0 out of range.
    """
    left, right, top, bottom = crop.unbind(-1)
    crop_w = (size - left - right).to(torch.float32)
    crop_h = (size - top - bottom).to(torch.float32)
    ty, tx = shift
    mean = imgs.mean(dim=(1, 2), keepdim=True)
    wy = resample_weights(size, size, size / crop_h, ty - top * size / crop_h)
    wx = resample_weights(size, size, size / crop_w,
                          tx - left * size / crop_w)
    with _full_float32_matmul(imgs.device):
        out = torch.einsum("nhwc,nho->nowc", imgs - mean, wy)
        out = torch.einsum("nowc,nwp->nopc", out, wx)
    out = out + mean

    sx = (size / torch.clamp(crop_w, min=1.0))[:, None]
    sy = (size / torch.clamp(crop_h, min=1.0))[:, None]
    left, top, tx, ty = (v[:, None] for v in (left, top, tx, ty))
    x1 = torch.clamp((boxes[..., 0] - left) * sx + tx, 0, size)
    y1 = torch.clamp((boxes[..., 1] - top) * sy + ty, 0, size)
    x2 = torch.clamp((boxes[..., 2] - left) * sx + tx, 0, size)
    y2 = torch.clamp((boxes[..., 3] - top) * sy + ty, 0, size)
    return out, _clip_boxes(boxes, x1, y1, x2, y2)[0]


def _mosaic_shifts(crop: torch.Tensor, flips: torch.Tensor,
                   cut_x: torch.Tensor, cut_y: torch.Tensor, size: int):
    """Per-member mosaic content translations (tx, ty) [B, 4] matching the
    reference's paste-window shifts (blend_mosaic): a member whose crop
    zoomed out (negative offsets, mean padding on that side) has its
    quadrant's window moved toward real content by
    ``trunc(min(limit, max(0, -offset * S / crop_w)))``, clamped twice; a
    flip swaps which side the left/right padding sits on. Quadrant pixel
    (x, y) shows member pixel (x - tx, y - ty), after the flip."""
    f32 = torch.float32
    left = torch.where(flips, crop[..., 1], crop[..., 0]).to(f32)
    right = torch.where(flips, crop[..., 0], crop[..., 1]).to(f32)
    top = crop[..., 2].to(f32)
    bottom = crop[..., 3].to(f32)
    crop_w = (size - crop[..., 0] - crop[..., 1]).to(f32)
    crop_h = (size - crop[..., 2] - crop[..., 3]).to(f32)
    s = float(size)
    fx = cut_x.to(f32)[:, None]
    fy = cut_y.to(f32)[:, None]
    zero = crop_w.new_zeros(())

    ls = torch.trunc(torch.minimum(fx, torch.maximum(zero, -left * s / crop_w)))
    ts = torch.trunc(torch.minimum(fy, torch.maximum(zero, -top * s / crop_h)))
    rs = torch.trunc(torch.minimum(s - fx,
                                   torch.maximum(zero, -right * s / crop_w)))
    bs = torch.trunc(torch.minimum(s - fy,
                                   torch.maximum(zero, -bottom * s / crop_h)))
    ls = torch.minimum(ls, s - fx)
    ts = torch.minimum(ts, s - fy)
    rs = torch.minimum(rs, fx)
    bs = torch.minimum(bs, fy)

    # members: [top-left, top-right, bottom-left, bottom-right]
    tx = torch.stack([-ls[:, 0], rs[:, 1], -ls[:, 2], rs[:, 3]], dim=1)
    ty = torch.stack([-ts[:, 0], -ts[:, 1], bs[:, 2], bs[:, 3]], dim=1)
    return tx, ty


def _flip(imgs: torch.Tensor, boxes: torch.Tensor, do_flip: torch.Tensor,
          size: int):
    """Horizontal flip of the members where ``do_flip`` [N] is set."""
    flipped = torch.where(do_flip[:, None, None, None], imgs.flip(2), imgs)
    valid = boxes.sum(dim=-1) > 0
    fb = torch.stack([size - boxes[..., 2], boxes[..., 1],
                      size - boxes[..., 0], boxes[..., 3], boxes[..., 4]],
                     dim=-1)
    fb = torch.where(valid[..., None], fb, fb.new_zeros(()))
    return flipped, torch.where(do_flip[:, None, None], fb, boxes)


def _dither(imgs: torch.Tensor, dhue: torch.Tensor, dsat: torch.Tensor,
            dexp: torch.Tensor, enabled: torch.Tensor) -> torch.Tensor:
    """HSV dithering of N members: hue + 179 * dhue, saturation * dsat,
    value * dexp, back to RGB clipped to [0, 255]; members with
    ``enabled`` false pass unchanged."""
    hsv = rgb_to_hsv(imgs)
    h = hsv[..., 0] + 179.0 * dhue[:, None, None]
    s = hsv[..., 1] * dsat[:, None, None]
    v = hsv[..., 2] * dexp[:, None, None]
    out = torch.clamp(hsv_to_rgb(torch.stack([h, s, v], dim=-1)), 0.0, 255.0)
    return torch.where(enabled[:, None, None, None], out, imgs)


def _mosaic(imgs: torch.Tensor, boxes: torch.Tensor, cut_x: torch.Tensor,
            cut_y: torch.Tensor, size: int, max_labels: int):
    """imgs [B, 4, S, S, 3], boxes [B, 4, K, 5] xyxy+cls -> the mosaic
    [B, S, S, 3] and its boxes [B, max_labels, 5]. Each quadrant shows its
    member's pixels at the same coordinates (the paste-window shifts are
    already in the members); each member's boxes are clipped to its
    quadrant, empty ones dropped, and the valid rows moved to the front in
    order (a stable sort) and cut to ``max_labels``."""
    b, _, k, _ = boxes.shape
    ys = torch.arange(size, device=imgs.device)[None, :, None, None]
    xs = torch.arange(size, device=imgs.device)[None, None, :, None]
    top = ys < cut_y[:, None, None, None]
    lft = xs < cut_x[:, None, None, None]
    out = torch.where(top & lft, imgs[:, 0],
                      torch.where(top, imgs[:, 1],
                                  torch.where(lft, imgs[:, 2], imgs[:, 3])))

    zero, full = torch.zeros_like(cut_x), torch.full_like(cut_x, size)
    bounds = torch.stack([
        torch.stack([zero, zero, cut_x, cut_y], dim=-1),
        torch.stack([cut_x, zero, full, cut_y], dim=-1),
        torch.stack([zero, cut_y, cut_x, full], dim=-1),
        torch.stack([cut_x, cut_y, full, full], dim=-1),
    ], dim=1).to(torch.float32)[:, :, None, :]                 # [B, 4, 1, 4]
    x1 = torch.clamp(boxes[..., 0], bounds[..., 0], bounds[..., 2])
    y1 = torch.clamp(boxes[..., 1], bounds[..., 1], bounds[..., 3])
    x2 = torch.clamp(boxes[..., 2], bounds[..., 0], bounds[..., 2])
    y2 = torch.clamp(boxes[..., 3], bounds[..., 1], bounds[..., 3])
    merged, valid = _clip_boxes(boxes, x1, y1, x2, y2)
    merged = merged.reshape(b, 4 * k, 5)
    order = torch.argsort(~valid.reshape(b, 4 * k), dim=1,
                          stable=True)[:, :max_labels]
    return out, torch.gather(merged, 1, order[..., None].expand(-1, -1, 5))


def apply_params(canvases: torch.Tensor, boxes: torch.Tensor,
                 params: Params, max_labels: int):
    """The deterministic half: canvases [B, 4, S, S, 3] uint8 and member
    boxes [B, 4, K, 5] with ``params`` from :func:`sample_params` ->
    (images [B, S, S, 3] float32 in [0, 1], labels [B, max_labels, 5]
    cxcywh+cls)."""
    b, _, size = canvases.shape[:3]
    k = boxes.shape[2]
    flips = params["flip"]
    imgs = canvases.reshape(b * 4, size, size, 3).to(torch.float32)
    # the paste-window shifts are defined after the flip; the crop runs
    # before it, and mirroring turns a translation u into -u
    tx, ty = _mosaic_shifts(params["crop"], flips, params["cut_x"],
                            params["cut_y"], size)
    ux = torch.where(flips, -tx, tx)
    imgs, bx = _crop(imgs, boxes.reshape(b * 4, k, 5),
                     params["crop"].reshape(b * 4, 4), size,
                     shift=(ty.reshape(-1), ux.reshape(-1)))
    imgs, bx = _flip(imgs, bx, flips.reshape(-1), size)
    imgs = _dither(imgs, params["dhue"].reshape(-1),
                   params["dsat"].reshape(-1), params["dexp"].reshape(-1),
                   params["dither"].reshape(-1))
    mosaic, mboxes = _mosaic(imgs.reshape(b, 4, size, size, 3),
                             bx.reshape(b, 4, k, 5), params["cut_x"],
                             params["cut_y"], size, max_labels)

    # xyxy -> cxcywh and /255
    valid = mboxes.sum(dim=-1) > 0
    labels = torch.stack([(mboxes[..., 0] + mboxes[..., 2]) / 2,
                          (mboxes[..., 1] + mboxes[..., 3]) / 2,
                          mboxes[..., 2] - mboxes[..., 0],
                          mboxes[..., 3] - mboxes[..., 1],
                          mboxes[..., 4]], dim=-1)
    labels = torch.where(valid[..., None], labels, labels.new_zeros(()))
    return mosaic / 255.0, labels


def augment_batch(generator: torch.Generator, canvases: torch.Tensor,
                  boxes: torch.Tensor, size: int, max_labels: int = 60,
                  jitter: float = 0.3, hue: float = 0.1,
                  saturation: float = 1.5, exposure: float = 1.5,
                  min_offset: float = 0.2, flip: bool = True,
                  dither: bool = True):
    """Batched device augmentation (the JAX package's ``augment_batch``).

    canvases [B, 4, S, S, 3] uint8 and boxes [B, 4, K, 5] float32 on the
    generator's device -> (images [B, S, S, 3] float32 in [0, 1], labels
    [B, max_labels, 5] cxcywh+cls). No host synchronisation.
    """
    if canvases.shape[2] != size:
        raise ValueError(f"canvases are {canvases.shape[2]} px, size {size}")
    params = sample_params(generator, canvases.shape[0], size, jitter, hue,
                           saturation, exposure, min_offset, flip, dither)
    return apply_params(canvases, boxes, params, max_labels)


def device_aug_config(cfg: Dict) -> Optional[Dict]:
    """augment_batch's keyword arguments from the AUGMENTATION section, or
    None when AUGMENTATION.DEVICE is off (the JAX package's
    engine/trainer.py reads the same keys)."""
    aug = cfg["AUGMENTATION"]
    if not aug.get("DEVICE", False):
        return None
    return {"jitter": aug["JITTER"], "hue": aug["HUE"],
            "saturation": aug["SATURATION"], "exposure": aug["EXPOSURE"],
            "min_offset": aug["MIN_OFFSET"],
            "flip": bool(aug["RANDOM_HORIZONTAL_FLIP"]),
            "dither": bool(aug["COLOR_DITHERING"])}


class CanvasTransform:
    """Host-side prep for the device pipeline: per mosaic member, BGR ->
    RGB, a stretch-resize to the canvas (cv2 INTER_LINEAR) and the boxes
    scaled to it; the augmentation runs on the device (augment_batch).
    Duck-types data/transforms.Transform (``is_mosaic`` makes the dataset
    draw four images a sample)."""

    is_mosaic = True
    is_train = True

    def __init__(self, cfg: Dict):
        self.max_num_labels = cfg["DATA"]["MAX_NUM_LABELS"]

    def seed(self, seed) -> None:  # no host randomness
        pass

    def __call__(self, img_list, bboxes_list, img_size: int):
        import cv2

        if len(img_list) != 4:
            raise ValueError(f"the device mosaic needs 4 members, got "
                             f"{len(img_list)}")
        k = self.max_num_labels
        canvases = np.zeros((4, img_size, img_size, 3), np.uint8)
        boxes = np.zeros((4, k, 5), np.float32)
        for m, (img, tlwh) in enumerate(zip(img_list, bboxes_list)):
            h, w = img.shape[:2]
            canvases[m] = cv2.resize(img[:, :, ::-1], (img_size, img_size),
                                     interpolation=cv2.INTER_LINEAR)
            if len(tlwh) > 0:
                n = min(len(tlwh), k)
                sx, sy = img_size / w, img_size / h
                boxes[m, :n, 0] = tlwh[:n, 0] * sx
                boxes[m, :n, 1] = tlwh[:n, 1] * sy
                boxes[m, :n, 2] = (tlwh[:n, 0] + tlwh[:n, 2]) * sx
                boxes[m, :n, 3] = (tlwh[:n, 1] + tlwh[:n, 3]) * sy
                boxes[m, :n, 4] = tlwh[:n, 4]
        return canvases, {"member_boxes": boxes, "img_info": []}
