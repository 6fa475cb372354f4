"""Greedy NMS over score-sorted candidates: the plain PyTorch version.

This is the reference the Hopper kernel (ops/nms_cuda.py) is held against,
and the path every CPU tensor takes. It solves the greedy recurrence

    keep[i] = valid[i]  and  no j < i with keep[j] and IoU[j, i] >= t

block by block: suppression from already-final earlier blocks is one
masked any-reduction, and only the [B, block, block] within-block
recurrence iterates, by Jacobi rounds from keep = base to the fixpoint.
The greedy result is the unique solution, so any correct solver gives the
same mask bit for bit (JAX package: ops/nms.py).

``pair_mask_words`` and ``scan_mask_words`` are the Hopper kernel's two
launches written out on the CPU, for the tests: their composition is the
same keep mask. The main path never calls them.
"""

from __future__ import annotations

import torch

from yolov4_tpu_torch.ops.boxes import iou_pairwise_safe


def _jacobi_fixpoint(pair: torch.Tensor, base: torch.Tensor) -> torch.Tensor:
    """Solve keep[i] = base[i] & no j<i with keep[j] & pair[j,i] by Jacobi
    iteration from keep = base; stops at the fixpoint, reached in
    suppression-chain-depth rounds."""
    keep = base
    while True:
        hit = (pair & keep[:, :, None]).any(dim=1)
        new_keep = base & ~hit
        if torch.equal(new_keep, keep):
            return keep
        keep = new_keep


def greedy_nms_mask(boxes_xyxy: torch.Tensor, valid: torch.Tensor,
                    iou_thresh: float, block: int = 256) -> torch.Tensor:
    """Greedy suppression over score-sorted candidates.

    Args:
      boxes_xyxy: [B, K, 4] float32, sorted by descending score along K.
      valid: [B, K] bool — below-threshold / padding slots are False.
      iou_thresh: suppress at IoU >= thresh (reference utils.py:77),
        compared in float32.
      block: rows finalized per step.

    Returns:
      keep: [B, K] bool.
    """
    k = boxes_xyxy.shape[-2]
    thresh = torch.tensor(iou_thresh, dtype=torch.float32,
                          device=boxes_xyxy.device)
    iou = iou_pairwise_safe(boxes_xyxy, boxes_xyxy)  # [B, K, K]
    idx = torch.arange(k, device=boxes_xyxy.device)
    # pair[b, j, i]: j would suppress i if j is kept (strictly upper-tri)
    pair = ((iou >= thresh) & (idx[:, None] < idx[None, :])
            & valid[:, :, None])
    del iou

    if k <= block:
        return _jacobi_fixpoint(pair, valid)

    parts = []
    for r0 in range(0, k, block):
        t = min(block, k - r0)
        base = valid[:, r0:r0 + t]
        if r0:
            # suppression by kept boxes in already-final earlier blocks
            keep_prev = torch.cat(parts, dim=1)  # [B, r0]
            ext = (pair[:, :r0, r0:r0 + t] & keep_prev[:, :, None]).any(dim=1)
            base = base & ~ext
        parts.append(_jacobi_fixpoint(pair[:, r0:r0 + t, r0:r0 + t], base))
    return torch.cat(parts, dim=1)


WORD = 64  # targets per mask word
# int64 value of each bit: 1 << 63 is the sign bit, so bit 63 reads negative
_BITS = torch.tensor([1 << u if u < 63 else -(1 << 63) for u in range(WORD)],
                     dtype=torch.int64)


def n_words(k: int) -> int:
    return (k + WORD - 1) // WORD


def _pack(bits: torch.Tensor) -> torch.Tensor:
    """[..., 64] bool -> [...] int64 words, bit u from bits[..., u]."""
    return torch.where(bits, _BITS.to(bits.device), 0).sum(-1)


def _unpack(words: torch.Tensor) -> torch.Tensor:
    """[...] int64 -> [..., 64] bool."""
    return (words[..., None] & _BITS.to(words.device)) != 0


def pair_mask_words(boxes_xyxy: torch.Tensor,
                    iou_thresh: float) -> torch.Tensor:
    """The kernel's pair mask (csrc/nms.cu, nms_mask_kernel): [B, K,
    n_words] int64, bit u of word w of row j set iff target i = 64w + u
    satisfies j < i < K and IoU(j, i) >= t, in float32 with the kernel's
    operations in the kernel's order (union clamped to 1e-12; at t > 0 a
    disjoint pair skips the division, as it does there). Words below the
    diagonal are 0; the kernel leaves them unwritten."""
    b, k, _ = boxes_xyxy.shape
    x = boxes_xyxy.float()
    area = (x[..., 2] - x[..., 0]) * (x[..., 3] - x[..., 1])
    s, t = x[:, :, None, :], x[:, None, :, :]
    iw = torch.clamp(torch.minimum(s[..., 2], t[..., 2])
                     - torch.maximum(s[..., 0], t[..., 0]), min=0.0)
    ih = torch.clamp(torch.minimum(s[..., 3], t[..., 3])
                     - torch.maximum(s[..., 1], t[..., 1]), min=0.0)
    inter = iw * ih
    union = torch.clamp(area[:, :, None] + area[:, None, :] - inter,
                        min=1e-12)
    thresh = torch.tensor(iou_thresh, dtype=torch.float32, device=x.device)
    hit = inter / union >= thresh
    if iou_thresh > 0:
        hit &= inter != 0
    idx = torch.arange(k, device=x.device)
    hit &= idx[:, None] < idx[None, :]
    nw = n_words(k)
    hit = torch.nn.functional.pad(hit, (0, nw * WORD - k))
    return _pack(hit.reshape(b, k, nw, WORD))


def _resolve_block(cand: torch.Tensor, diag: torch.Tensor) -> torch.Tensor:
    """nms.cu's resolve_block for each image: the keep word of one row
    block from its standing candidates cand [B] and diagonal words diag
    [B, 64] (row u's targets inside the block)."""
    cbits = _unpack(cand)                                   # [B, 64]
    dbits = _unpack(diag)                                   # [B, 64(u), 64]
    hit = (dbits & cbits[:, :, None]).any(1)                # some cand hits
    quiet = ~(dbits & cbits[:, None, :]).any(2)             # hits no cand
    keep = cbits & ~hit & quiet
    left = cbits & ~keep
    for u in range(WORD):  # rank order: the lowest undecided one is kept
        take = left[:, u]
        keep[:, u] |= take
        left &= ~(dbits[:, u] & take[:, None])
    return _pack(keep)


def scan_mask_words(words: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """The kernel's scan (csrc/nms.cu, nms_scan_kernel) over a pair mask
    laid out as ``pair_mask_words`` returns it: keep [B, K] bool.

    Per image, the removed bitset starts as the invalid candidates and the
    bits past K; row block r (candidates 64r .. 64r + 63) is resolved from
    removed[r] and its diagonal words, then its kept rows are ORed into
    removed[w] for w > r."""
    b, k = valid.shape
    nw = n_words(k)
    vbits = torch.nn.functional.pad(valid, (0, nw * WORD - k))
    removed = ~_pack(vbits.reshape(b, nw, WORD))            # [B, nw]
    keep_words = []
    for r in range(nw):
        rows = words[:, r * WORD:min(k, (r + 1) * WORD)]    # [B, n, nw]
        diag = torch.nn.functional.pad(rows[:, :, r],
                                       (0, WORD - rows.shape[1]))
        kw = _resolve_block(~removed[:, r], diag)
        keep_words.append(kw)
        kept = _unpack(kw)[:, :rows.shape[1], None]         # [B, n, 1]
        later = _unpack(rows[:, :, r + 1:]) & kept[..., None]
        removed[:, r + 1:] |= _pack(later.any(1))
    keep = _unpack(torch.stack(keep_words, 1)).reshape(b, nw * WORD)
    return keep[:, :k]
