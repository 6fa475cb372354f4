#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (yolov4_tpu_torch) on one NVIDIA GPU.

Usage (from the root of a checkout, on a machine with a CUDA card and the
CUDA toolkit):

    python3 chip_smoke.py

Phases; any failure ends the run with a non-zero exit code and no result
line:

  1. build   — compile yolov4_tpu_torch/csrc/nms.cu and csrc/csp.cu with
               nvcc for sm_90a, one nvcc each, started together; print
               -Xptxas -v's report of each K1 kernel (registers, spills,
               shared memory; none may spill) and of each bf16 K2 kernel
               instance (registers, spills, notes) with its dynamic shared
               memory; the instances the 608 stages launch must not spill
               and must use more than 48 KB of dynamic shared memory.
  2. kernel  — the greedy-NMS kernel (K1) against its plain PyTorch version
               on the card: keep masks bit-equal on the cases of
               tests/test_nms_pallas.py, ragged K, t = 0, K = 6000 (94 mask
               words: more than a warp's lanes), K = 12000 (near the most
               the scan's ring of two slabs holds), K = 16384 (above that:
               the scan reads device memory), the main-path shape (B=16,
               K=2048, t=0.4, class-offset coordinates) and a suppression-heavy
               input (few classes, small spread); under batch isolation;
               and each of its two launches against its CPU-side
               description (ops/nms.pair_mask_words, scan_mask_words).
  3. main    — the detection path at the full width of YOLOv4
               (CSPDarknet53, 80 classes, 608x608, batch 16, bfloat16,
               seeded random weights) through Predictor: launches counted,
               outputs checked, the same decoded predictions through the
               plain NMS give identical detections; K1 and the plain
               version timed on the NMS inputs this path produced, and K1
               on the suppression-heavy input: ms is one call between CUDA
               events, the host's enqueue included, as every kernel's;
               device_ms, and each of K1's two launches, are timed with a
               spin kernel queued ahead, so that the enqueue is not.
  4. device  — the port at WIDTH 0.25 in float32 (TF32 off) on the card
               against the same model on the CPU, decoded predictions
               within atol = rtol = 1e-3.
  5. detect  — ``python -m yolov4_tpu_torch.detect``'s entry point on four
               synthetic JPEGs writes four drawn images.
  6. k2      — the fused CSP stage kernel (K2) against its plain version at
               the three stage shapes of 608/b16 and three ragged shapes
               (C = 16, 24 and 18, the last not a multiple of 8), in
               float32 (TF32 off) and bfloat16 (tolerances at K2_TOL_*).
  7. fused   — the full-width 608/b16 bfloat16 forward with PALLAS_CSP on,
               BN re-drawn: K2 launches 3 times and its conv kernels 14
               times (ops/csp.launch_plan), its decoded predictions agree
               with the default path's (FUSED_TOL_*); each stage body on its
               real input: K2 against its plain version, its conv launches
               against launch_plan, timed beside the plain version, the
               default layer-by-layer body and cuDNN's convs alone on the
               same folded weights (a yardstick the port never calls), with
               its bound, the launch plan's bound and the achieved TFLOP/s,
               and K2's device time with a spin kernel queued ahead;
               the Predictor with PALLAS_CSP on, timed as in phase 3.
  8. val     — ``python -m yolov4_tpu_torch.val``'s entry point at full
               width with PALLAS_CSP on, batch 16, conf 0.001, on a
               synthetic COCO val2017 of 32 images: finite AP in [0, 1],
               AP50 >= AP, K1 once and K2 three times per batch.
  9. train   — the train step at WIDTH 0.25, 128x128, batch 4, SGD,
               ACCUMULATION_STEPS 2: two micro-steps on the card against
               the same two on the CPU from one init seed, in float32 (TF32
               off; loss, the parameters' change as a whole and per tensor,
               and BN buffers within TRAIN_TOL_*), then in float64 at init
               seeds 1 and 5 (TRAIN_F64_TOL_*: each tensor's change within
               1e-9 of its largest, BN buffers within 1e-10).
 10. train   — full width, 608x608, batch 8, bfloat16 autocast over
     full      float32 weights, Adam: 3 warm steps, then 20 timed with
               CUDA events (ms per step, img/s, peak memory, the share of
               the bf16 peak that the model's FLOPs reach, train FLOPs =
               3x the forward's conv FLOPs); a fresh model's 30 steps on
               one batch without warmup (finite, falling loss); then
               ``Trainer.fit`` on a synthetic COCO (64 train2017 JPEGs,
               mosaic; 16 val2017 images, PALLAS_CSP on;
               ACCUMULATION_STEPS 2; 2 epochs) three ways: host
               augmentation with 4 loader workers (then a resume from its
               checkpoint for a third epoch: epoch, step and best AP
               carried over), host augmentation with 8 workers, and
               AUGMENTATION.DEVICE (then a resume from its first epoch's
               checkpoint, whose first losses must equal the uninterrupted
               run's, RESUME_TOL); K1 and K2 counted in each run's
               validations; each run's img/s per epoch, loader included.
 11. aug     — AUGMENTATION.DEVICE's augmentation (data/device_aug.py):
               parameters drawn on the CPU and applied on the card and on
               the CPU at 608/b2 (AUG_TOL_*); two calls with one (seed,
               step) equal and free of host synchronisation;
               augment_batch timed at 608/b8 (per call and device time),
               and the full-width train step with it inside beside the
               step on the same batch already augmented.

Then it prints the card's name and power limit (nvidia-smi), one JSON line
``{"kernels": [...]}`` and, last, ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet): float32 outside the tensor
# cores, and HBM3 bandwidth.
PEAK_F32_OPS = 67e12
PEAK_BF16_OPS = 989e12  # dense tensor cores
PEAK_BYTES = 3.35e12
# float32 operations of the kernel's pair test (Pallas formula): 2 min,
# 2 max, 2 sub, 2 clamp for iw/ih; 1 mul; 1 add + 1 sub + 1 clamp for the
# union; 1 div; 1 compare
OPS_PER_PAIR = 14
OPS_PER_BOX = 3  # area

# K2 against its plain version: max |got - want| / (1 + |want|). float32
# (TF32 off) differs only in summation order; bfloat16 rounds at the same
# points, but where the two float32 sums straddle a rounding boundary an
# intermediate differs by one ulp, and stage 3's chain of 8 residual blocks
# carries such differences on (a few ulps at the output).
K2_TOL_F32 = 1e-4
K2_TOL_BF16 = 0.05
# ... and the bfloat16 kernel's mean |error| against a float32 evaluation of
# the same function may exceed the plain bfloat16 version's by this factor
K2_TOL_BF16_VS_F32 = 1.25
# The train step on the card (TF32 off) against the CPU, float32, two
# micro-steps: the loss, relative; the parameters' change over the whole
# model, as the L2 norm of the difference over the L2 norm of the CPU's
# change, and in each tensor, against the largest change in it; the BN
# buffers, relative and absolute. Two convolution backends differ in
# summation order only, but a float32 train step from the reference init
# can be ill-conditioned: for some init seeds float32 and float64 on the
# CPU alone give changes 1-2% apart in L2 and single tensors up to 15% of
# their largest change. Init seed 1 is a well-conditioned instance there
# (5.3e-4 in L2, 0.76% in the worst tensor), so that a gap on the card
# shows.
TRAIN_SEED = 1
TRAIN_TOL_LOSS = 1e-4
TRAIN_TOL_UPDATE_L2 = 1e-2
TRAIN_TOL_UPDATE_TENSOR = 5e-2
TRAIN_TOL_BUF = (1e-3, 1e-5)
# ... and the same two micro-steps in float64 at init seeds 1 and 5, where
# conditioning cannot hide a device fault: the losses, relative; each
# parameter's change against its tensor's largest change; each BN buffer
# against its largest magnitude.
TRAIN_F64_SEEDS = (1, 5)
TRAIN_F64_TOL_LOSS = 1e-12
TRAIN_F64_TOL_UPDATE_TENSOR = 1e-9
TRAIN_F64_TOL_BUF = 1e-10
# The fused bfloat16 forward against the default one, decoded: both round to
# bfloat16 at different points (the default path rounds conv outputs, BN and
# each Mish step; K2 keeps them in float32), so each is held against a
# float32 forward of the same weights: the fused path's mean |error| on the
# scores and on the boxes may exceed the default path's by this factor.
FUSED_TOL_VS_F32 = 1.25
# The device augmentation on the card against the CPU with the same
# parameters: pixels on the [0, 1] scale and boxes in pixels. Both run the
# same float32 operations; the resample's products sum in another order.
AUG_TOL_IMG = 1e-3
AUG_TOL_BOX_PX = 1e-3
# A device-aug Trainer resumed from a checkpoint against the uninterrupted
# run: the relative gap of the first two losses after the resume (same
# weights, same augmented batches).
RESUME_TOL = 1e-6
STAGE_SHAPES = ((16, 304, 304, 64, 0), (16, 152, 152, 128, 2),
                (16, 76, 76, 256, 8))
RAGGED_SHAPES = ((2, 9, 13, 16, 0), (3, 11, 7, 24, 3), (2, 5, 7, 18, 1))


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3,
            queue_ahead: bool = False) -> float:
    """Median time of one call of ``fn``, from CUDA events. Between the
    events the card also idles while the host enqueues the call; with
    ``queue_ahead`` a ~2 ms spin kernel runs first, so that the call is
    enqueued before the card reaches it and the events time its kernels
    alone (device time)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if queue_ahead:
            torch.cuda._sleep(4_000_000)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def nms_case(seed, b, k, valid_p=0.85, spread=300.0, wh_hi=150.0):
    """tests/test_nms_pallas.py::_case, draw for draw."""
    r = np.random.default_rng(seed)
    c = r.uniform(0, spread, (b, k, 2)).astype(np.float32)
    wh = r.uniform(15, wh_hi, (b, k, 2)).astype(np.float32)
    return np.concatenate([c, c + wh], -1), r.random((b, k)) < valid_p


def nms_bound(b: int, k: int):
    """(bound_ms, bound_by) for one keep mask of B images of K boxes:
    operations on every pair j < i, and the bytes read (boxes, valid) and
    written (keep) once."""
    ops = OPS_PER_PAIR * b * k * (k - 1) / 2 + OPS_PER_BOX * b * k
    nbytes = b * k * (16 + 1 + 1)
    t_ops, t_bytes = ops / PEAK_F32_OPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def nms_suppressed_case(seed=31, b=16, k=2048):
    """Suppression-heavy NMS input, as conf 0.001 with trained weights
    gives: valid_p 0.9, boxes 15 to 160 px wide over a 50 px spread, in 4
    classes, class-offset as on the main path; most candidates are
    suppressed."""
    boxes, valid = nms_case(seed, b, k, 0.9, 50.0, 160.0)
    cls = np.random.default_rng(seed + 1).integers(0, 4, (b, k, 1))
    span = np.float32(2.0 * np.abs(boxes).max() + 1.0)
    return (boxes + cls * span).astype(np.float32), valid, 0.4


def check_halves(nms_cuda, boxes, valid, t, label):
    """K1's two launches against their CPU-side descriptions on the card:
    the mask launch's words (rows below K, words at or above the diagonal,
    the only ones it writes) equal ops/nms.pair_mask_words', and the scan
    launch on them equals ops/nms.scan_mask_words'."""
    from yolov4_tpu_torch.ops.nms import pair_mask_words, scan_mask_words
    k = boxes.shape[1]
    mask = nms_cuda.pair_mask_words_cuda(boxes, t)
    want = pair_mask_words(boxes, t)
    got = mask[:, :k]
    row_block = torch.arange(k, device=boxes.device)[:, None] // 64
    upper = torch.arange(got.shape[-1], device=boxes.device) >= row_block
    if not torch.equal(torch.where(upper, got, 0), want):
        raise AssertionError(f"K1 {label}: mask words differ at "
                             f"{int(((got != want) & upper).sum())} places")
    keep = nms_cuda.scan_mask_words_cuda(mask, valid)
    torch.cuda.synchronize()
    if not torch.equal(keep, scan_mask_words(mask, valid)):
        raise AssertionError(f"K1 {label}: the scan launch differs from "
                             f"scan_mask_words")


def phase_kernel_cases(nms_cuda, plain, report):
    """K1 bit-equal to the plain version on the card; returns max |err|."""
    cases = [(*nms_case(s, 2, 1024), 0.45) for s in range(3)]
    cases.append((*nms_case(11, 3, 512, 0.95, 150.0, 200.0), 0.4))
    cases.append((*nms_case(5, 4, 256), 0.5))
    zeros = np.zeros((1, 256, 4), np.float32)
    cases.append((zeros, np.zeros((1, 256), bool), 0.4))
    some = np.zeros((1, 256), bool)
    some[:, :10] = True
    cases.append((zeros, some, 0.4))
    cases.append((*nms_case(8, 3, 1000), 0.45))  # ragged K
    cases.append((*nms_case(0, 2, 300), 0.45))
    boxes, valid = nms_case(21, 16, 2048, 0.9, 608.0, 300.0)
    cls = np.random.default_rng(22).integers(0, 80, (16, 2048, 1))
    span = np.float32(2.0 * np.abs(boxes).max() + 1.0)
    cases.append(((boxes + cls * span).astype(np.float32), valid, 0.4))
    cases.append((*nms_case(12, 2, 256), 0.0))   # disjoint pairs suppress
    cases.append((*nms_case(13, 2, 6000, 0.9, 3000.0, 300.0), 0.45))
    cases.append((*nms_case(14, 1, 12000, 0.9, 6000.0, 300.0), 0.45))
    cases.append((*nms_case(15, 1, 16384, 0.9, 8000.0, 300.0), 0.45))
    cases.append(nms_suppressed_case())
    err, rows = 0.0, []
    for i, (boxes, valid, t) in enumerate(cases):
        bx = torch.from_numpy(boxes).cuda()
        vd = torch.from_numpy(valid).cuda()
        got = nms_cuda.greedy_nms_mask_cuda(bx, vd, t)
        torch.cuda.synchronize()
        want = plain(bx, vd, t)
        b, k = valid.shape
        rows.append(dict(b=b, k=k, t=t, slots=nms_cuda.scan_slots(k),
                         valid=int(valid.sum()), kept=int(got.sum())))
        if not torch.equal(got, want):
            raise AssertionError(
                f"K1 case {i} {tuple(boxes.shape)} t={t}: keep masks differ "
                f"at {int((got != want).sum())} positions")
        err = max(err, float((got.float() - want.float()).abs().max()))
        if k <= 2048:
            check_halves(nms_cuda, bx, vd, t, f"case {i}")
        del bx, vd, got, want
        torch.cuda.empty_cache()
    if {bool(r["slots"]) for r in rows} != {False, True}:
        raise AssertionError(f"K1 cases miss a scan variant: {rows}")
    # batch isolation: each image alone gives its row of the batched mask
    boxes, valid = nms_case(5, 4, 256)
    bx, vd = torch.from_numpy(boxes).cuda(), torch.from_numpy(valid).cuda()
    full = nms_cuda.greedy_nms_mask_cuda(bx, vd, 0.5)
    for i in range(4):
        solo = nms_cuda.greedy_nms_mask_cuda(bx[i:i + 1], vd[i:i + 1], 0.5)
        if not torch.equal(full[i], solo[0]):
            raise AssertionError(f"K1 batch isolation: image {i} differs")
    log(f"[kernel] {len(cases)} cases + batch isolation bit-equal to the "
        f"plain version, each launch equal to its CPU-side description "
        f"(K <= 2048), max_abs_err {err}; cases (B, K, t, slabs, valid, "
        f"kept): {[tuple(r.values()) for r in rows]}")
    report["k1_cases"] = rows
    return err


def k1_build_report(nms_cuda, report):
    """-Xptxas -v's figures for each K1 kernel; none may spill."""
    rows = nms_cuda.kernel_report(2048)
    for r in rows:
        log(f"[build] K1 {r['name']}: ptxas {r['registers']} registers, "
            f"{r['stack']} B stack, {r['spill_stores']} / {r['spill_loads']} "
            f"B spill stores / loads, {r['static_smem']} B static and "
            f"{r['dynamic_smem']} B dynamic shared memory at K=2048")
        if r["spill_stores"] or r["spill_loads"]:
            raise AssertionError(f"K1 kernel spills: {r}")
    if len(rows) != 3:
        raise AssertionError(f"expected the mask kernel and two scan "
                             f"variants in the build log, got {rows}")
    report["k1_build"] = rows


def library_nms_ms(boxes, valid, t):
    """torchvision.ops.batched_nms on the same class-offset boxes, grouped
    by image, as a yardstick only (the port never calls it; it suppresses
    at IoU > t where the port does at >= t); None when torchvision is not
    installed."""
    try:
        from torchvision.ops import batched_nms
    except ImportError:
        return None
    b, k, _ = boxes.shape
    rows = valid.reshape(-1)
    scores = torch.linspace(1.0, 0.0, k, device=boxes.device).repeat(b)
    groups = torch.arange(b, device=boxes.device).repeat_interleave(k)
    fb, fs, fg = boxes.reshape(-1, 4)[rows], scores[rows], groups[rows]
    return cuda_ms(lambda: batched_nms(fb, fs, fg, t))


def time_k1(nms_cuda, plain, boxes, valid, t):
    """K1 on the main path's NMS input: bit-equal to the plain version, then
    timed whole and launch by launch, beside the plain version, its bound
    and a library NMS where one is installed."""
    b, k, _ = boxes.shape
    want = plain(boxes, valid, t)
    got = nms_cuda.greedy_nms_mask_cuda(boxes, valid, t)
    if not torch.equal(got, want):
        raise AssertionError("K1 differs from the plain version on the main "
                             "path's NMS input")
    check_halves(nms_cuda, boxes, valid, t, "main-path input")
    res = dict(b=b, k=k, t=t, valid=int(valid.sum()), kept=int(got.sum()),
               **time_k1_launches(nms_cuda, boxes, valid, t),
               plain_ms=cuda_ms(lambda: plain(boxes, valid, t), iters=5),
               library_ms=library_nms_ms(boxes, valid, t))
    res["bound_ms"], res["bound_by"] = nms_bound(b, k)
    log(f"[kernel] main-path input B={b} K={k} t={t} ({res['valid']} valid, "
        f"{res['kept']} kept): K1 {res['ms']:.4f} ms with the host's "
        f"enqueue, device {res['device_ms']:.4f} ms (mask launch "
        f"{res['mask_ms']:.4f}, scan launch {res['scan_ms']:.4f}), plain "
        f"{res['plain_ms']:.4f} ms, bound {res['bound_ms']:.5f} ms by "
        f"{res['bound_by']}, library {res['library_ms']}")
    return res


def time_k1_launches(nms_cuda, boxes, valid, t):
    """One K1 call with the host's enqueue (ms, as every kernel is
    timed), and its device time (the queue filled ahead) whole and launch
    by launch."""
    mask = nms_cuda.pair_mask_words_cuda(boxes, t)
    return dict(
        ms=cuda_ms(lambda: nms_cuda.greedy_nms_mask_cuda(boxes, valid, t)),
        device_ms=cuda_ms(lambda: nms_cuda.greedy_nms_mask_cuda(boxes, valid,
                                                                t),
                          queue_ahead=True),
        mask_ms=cuda_ms(lambda: nms_cuda.pair_mask_words_cuda(boxes, t),
                        queue_ahead=True),
        scan_ms=cuda_ms(lambda: nms_cuda.scan_mask_words_cuda(mask, valid),
                        queue_ahead=True))


def time_k1_suppressed(nms_cuda, plain):
    """K1 on the suppression-heavy input (checked in phase 2), timed whole
    and launch by launch."""
    boxes, valid, t = nms_suppressed_case()
    bx, vd = torch.from_numpy(boxes).cuda(), torch.from_numpy(valid).cuda()
    kept = int(nms_cuda.greedy_nms_mask_cuda(bx, vd, t).sum())
    res = dict(b=16, k=2048, t=t, valid=int(valid.sum()), kept=kept,
               **time_k1_launches(nms_cuda, bx, vd, t),
               plain_ms=cuda_ms(lambda: plain(bx, vd, t), iters=5))
    log(f"[kernel] suppression-heavy input B=16 K=2048 t={t} "
        f"({res['valid']} valid, {kept} kept): K1 {res['ms']:.4f} ms with "
        f"the host's enqueue, device {res['device_ms']:.4f} ms (mask "
        f"launch {res['mask_ms']:.4f}, scan launch {res['scan_ms']:.4f}), "
        f"plain {res['plain_ms']:.4f} ms")
    return res


def phase_main(cfg, nms_cuda, postprocess_mod, Predictor, report):
    """The full-width detection path; returns the NMS inputs it produced."""
    batch, size, n_batches = 16, cfg["TEST"]["IMGSIZE"], 4
    t0 = time.time()
    pred = Predictor(cfg, img_size=size, batch_size=batch, device="cuda")
    params = sum(p.numel() for p in pred.model.parameters())
    log(f"[main] YOLOv4 {params / 1e6:.2f}M params, "
        f"{cfg['MODEL']['COMPUTE_DTYPE']}, {size}x{size}, batch {batch}, "
        f"built in {time.time() - t0:.1f}s")
    rng = np.random.default_rng(0)
    images = [rng.integers(0, 256, (batch, size, size, 3), dtype=np.uint8)
              for _ in range(n_batches)]
    pred.warmup()
    pred(images[0])

    captured = []
    wrapped = postprocess_mod.greedy_nms_mask_cuda

    def capture(boxes, valid, t):
        captured.append((boxes.clone(), valid.clone(), t))
        return wrapped(boxes, valid, t)

    postprocess_mod.greedy_nms_mask_cuda = capture
    try:
        nms_cuda.greedy_nms_mask_cuda.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = [pred(imgs) for imgs in images]
        e2e_s = time.perf_counter() - t0
        launches = nms_cuda.greedy_nms_mask_cuda.launches
    finally:
        postprocess_mod.greedy_nms_mask_cuda = wrapped
    if launches != n_batches:
        raise AssertionError(f"K1 launched {launches} times in "
                             f"{n_batches} batches")
    for det, valid in outs:
        if det.shape != (batch, 100, 7) or valid.shape != (batch, 100):
            raise AssertionError(f"detections {det.shape}, valid {valid.shape}")
        if not np.isfinite(det).all():
            raise AssertionError("non-finite detections")
        if not valid.any():
            raise AssertionError("no detection at all")
    img_s = batch * n_batches / e2e_s
    log(f"[main] {n_batches} batches through Predictor: K1 launches "
        f"{launches}, e2e {img_s:.2f} img/s (host clock, upload to fetch)")

    x = pred.upload(images[0])
    with torch.inference_mode():
        preds = pred.model(x.permute(0, 3, 1, 2).float() / 255.0)
        kw = dict(pre_nms_topk=pred.pre_nms_topk, max_dets=pred.max_dets,
                  cat_cap=pred.cat_cap)
        auto = postprocess_mod.postprocess(
            preds, pred.num_classes, pred.conf_thre, pred.nms_thre, **kw)
        plain = postprocess_mod.postprocess(
            preds, pred.num_classes, pred.conf_thre, pred.nms_thre,
            nms_engine="plain", **kw)
        if not (torch.equal(auto[0], plain[0])
                and torch.equal(auto[1], plain[1])):
            raise AssertionError("detections through K1 differ from the "
                                 "plain NMS's")
        n_kept = int(auto[1].sum())
        fwd_ms = cuda_ms(lambda: pred.model(
            x.permute(0, 3, 1, 2).float() / 255.0), iters=10)
        post_ms = cuda_ms(lambda: postprocess_mod.postprocess(
            preds, pred.num_classes, pred.conf_thre, pred.nms_thre, **kw),
            iters=10)
        run_ms = cuda_ms(lambda: pred.run(x), iters=10)
    log(f"[main] K1 and plain NMS give identical detections "
        f"({n_kept} valid rows); device ms per batch of {batch}: "
        f"fwd+decode {fwd_ms:.3f}, postprocess {post_ms:.3f}, "
        f"normalize+fwd+NMS {run_ms:.3f} ({batch * 1e3 / run_ms:.1f} img/s)")
    report["main"] = dict(batch=batch, img_size=size, n_batches=n_batches,
                          launches=launches, e2e_img_s=img_s,
                          fwd_ms=fwd_ms, post_ms=post_ms, run_ms=run_ms,
                          device_img_s=batch * 1e3 / run_ms,
                          valid_rows=n_kept, params=params)
    del pred, preds
    return captured, launches


@contextmanager
def tf32_off():
    """Full float32 convolutions and matrix products inside the block."""
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags


def redraw_bn(sd, rng):
    """BN re-drawn away from the reference's N(0, 0.01) scales, which would
    decay every activation to ~0 and make a comparison vacuous; conv biases
    (the heads' outputs) spread over U(-4, 1)."""
    for key, val in sd.items():
        if key.endswith("norm.weight") or key.endswith("running_var"):
            sd[key] = torch.from_numpy(rng.uniform(0.5, 0.8, val.shape)
                                       .astype(np.float32))
        elif key.endswith("running_mean"):
            sd[key] = torch.from_numpy(rng.normal(0, 0.1, val.shape)
                                       .astype(np.float32))
        elif key.endswith("conv.bias"):
            sd[key] = torch.from_numpy(rng.uniform(-4, 1, val.shape)
                                       .astype(np.float32))
    return sd


def phase_device_vs_cpu(cfg_cls, build_model, report):
    """WIDTH 0.25 float32 on the card (TF32 off) against the CPU."""
    cfg = cfg_cls.from_dict({
        "MODEL": {"WIDTH": 0.25, "DEPTH": 0.25, "COMPUTE_DTYPE": "float32"},
        "TEST": {"IMGSIZE": 320}})
    model = build_model(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(1))
    rng = np.random.default_rng(1)
    sd = redraw_bn(model.state_dict(), rng)
    model.load_state_dict(sd)
    model.eval()
    gpu = build_model(cfg, device="cuda")
    gpu.load_state_dict(sd)
    gpu.eval()
    x = torch.from_numpy(rng.random((2, 3, 320, 320), dtype=np.float32))
    with tf32_off(), torch.inference_mode():
        want = model(x).numpy()
        got = gpu(x.cuda()).cpu().numpy()
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-3)
    err = float(np.abs(got - want).max())
    log(f"[device] WIDTH 0.25 f32 at 320: card vs CPU decoded "
        f"{tuple(got.shape)}, max |diff| {err:.3g} (atol = rtol = 1e-3)")
    report["device_vs_cpu_max_abs"] = err


def phase_detect(detect_mod, nms_cuda, report):
    import cv2
    work = ROOT / "runs" / "chip_smoke"
    shutil.rmtree(work, ignore_errors=True)
    src = work / "src"
    src.mkdir(parents=True)
    rng = np.random.default_rng(5)
    names = []
    for i, (h, w) in enumerate([(480, 640), (608, 608), (375, 500),
                                (720, 1280)]):
        yy, xx = np.mgrid[0:h, 0:w]
        img = np.stack([(xx * 255 // w), (yy * 255 // h),
                        rng.integers(0, 256, (h, w))], -1).astype(np.uint8)
        cv2.rectangle(img, (w // 4, h // 4), (w // 2, h // 2),
                      (0, 0, 255), -1)
        names.append(f"img{i}.jpg")
        if not cv2.imwrite(str(src / names[-1]), img):
            raise OSError("cannot write a test JPEG")
    before = nms_cuda.greedy_nms_mask_cuda.launches
    t0 = time.time()
    dest = detect_mod.main(["--source", str(src), "--dest",
                            str(work / "out"), "--batch-size", "4"])
    written = sorted(p.name for p in dest.iterdir())
    if written != sorted(names):
        raise AssertionError(f"detect wrote {written}")
    for name in names:
        if cv2.imread(str(dest / name)) is None:
            raise AssertionError(f"unreadable output {name}")
    launched = nms_cuda.greedy_nms_mask_cuda.launches - before
    if launched != 1:
        raise AssertionError(f"detect launched K1 {launched} times")
    log(f"[detect] 4 synthetic JPEGs -> {len(written)} drawn images in "
        f"{time.time() - t0:.1f}s (K1 launched {launched}x)")
    shutil.rmtree(work, ignore_errors=True)
    report["detect_images"] = len(written)


def build_kernels(modules, report):
    """Build every kernel library at once, one nvcc each."""
    t0 = time.time()
    with ThreadPoolExecutor(len(modules)) as pool:
        libs = list(pool.map(lambda m: m.build(), modules))
    report["build_s"] = time.time() - t0
    log(f"[build] {', '.join(p.name for p in libs)} in "
        f"{report['build_s']:.1f}s")


def k2_build_report(csp_cuda, kernel_widths, report):
    """-Xptxas -v's figures for each bf16 K2 instance; the instances of the
    608 stages must not spill and must take > 48 KB of dynamic shared
    memory (the ring)."""
    rows = csp_cuda.kernel_report()
    main = {(kind, kernel_widths(c, nb)[0]) for _, _, _, c, nb in STAGE_SHAPES
            for kind in csp_cuda.plan_kinds(nb)}
    for r in rows:
        r["main_path"] = (r["kind"], r["cp"]) in main
        log(f"[build] K2 {r['kind']}<{r['cp']}>: ptxas {r['registers']} "
            f"registers, {r['stack']} B stack, {r['spill_stores']} / "
            f"{r['spill_loads']} B spill stores / loads, "
            f"{r['dynamic_smem']} B dynamic shared memory"
            + (f", notes {r['notes']}" if r["notes"] else "")
            + (" (main path)" if r["main_path"] else ""))
        if r["main_path"] and (r["spill_stores"] or r["spill_loads"]
                               or r["dynamic_smem"] <= 48 * 1024):
            raise AssertionError(f"K2 instance {r['kind']}<{r['cp']}> "
                                 f"spills or has <= 48 KB of ring: {r}")
    if {(r["kind"], r["cp"]) for r in rows} < main:
        raise AssertionError("the build log lacks a main-path K2 instance")
    report["k2_build"] = rows


def k2_shapes(c, nb):
    """(ci, co, k) of each conv of a stage body, by folded-dict name."""
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


def k2_case(seed, b, h, w, c, nb):
    """x [B, H, W, C] and folded weights on the card, drawn from a seed
    and scaled so that activations stay O(1) through the stage."""
    g = torch.Generator().manual_seed(seed)
    folded = {name: ((torch.randn((k, k, ci, co), generator=g)
                      / (k * k * ci) ** 0.5).cuda(),
                     (torch.rand(co, generator=g) - 0.5).cuda())
              for name, (ci, co, k) in k2_shapes(c, nb).items()}
    x = torch.randn((b, h, w, c), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(seed))
    return x, folded


def k2_ops(x, folded):
    """Multiply-adds x 2 of every conv of a stage body at every pixel."""
    b, h, w, _ = x.shape
    return 2 * b * h * w * sum(k.numel() for k, _ in folded.values())


def k2_weight_bytes(x, folded):
    return sum(k.numel() * x.element_size() + bias.numel() * 4
               for k, bias in folded.values())


def k2_bound(x, folded):
    """(bound_ms, bound_by) of one stage body on NHWC x: every conv's
    multiply-adds at every pixel over the peak of x's type, against x, the
    weights and the output moved once."""
    nbytes = 2 * x.numel() * x.element_size() + k2_weight_bytes(x, folded)
    peak = PEAK_BF16_OPS if x.dtype == torch.bfloat16 else PEAK_F32_OPS
    t_ops, t_bytes = k2_ops(x, folded) / peak, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def plan_bound(x, folded, nb, launch_plan):
    """(bound_ms, bound_by) of the launch plan: the same operations against
    the bytes each launch must move, each value it reads from memory
    (the 3x3 sources, residuals, x1) read once, each value it stores
    written once, and its weights."""
    b, h, w, c = x.shape
    m, isz = b * h * w, x.element_size()
    width = {"x": c}
    nbytes = 0
    for launch in launch_plan(c, nb):
        made, read = set(), set()
        for g in launch.gemms:
            read |= {v for v in (*g.srcs, g.res) if v and v not in made}
            for conv, out in zip(g.convs, g.outs):
                width[out] = folded[conv][0].shape[-1]
                nbytes += (folded[conv][0].numel() * isz
                           + folded[conv][1].numel() * 4)
            made |= set(g.outs)
        nbytes += m * isz * sum(width[v] for v in (*read, *launch.stores))
    t_ops = k2_ops(x, folded) / PEAK_BF16_OPS
    t_bytes = nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def cudnn_convs(x, folded):
    """A callable running one F.conv2d per conv of the stage on the folded
    weights, channels-last in x's dtype, on inputs of each conv's width
    (x itself where the width is C): cuDNN's convolutions without bias,
    Mish or residual, as a yardstick. The port never calls it."""
    import torch.nn.functional as F
    b, h, w, c = x.shape
    g = torch.Generator("cuda").manual_seed(9)
    inputs = {c: x.permute(0, 3, 1, 2)}
    convs = []
    for kernel, _ in folded.values():
        k, _, ci, _ = kernel.shape
        if ci not in inputs:
            inputs[ci] = torch.randn((b, ci, h, w), device=x.device,
                                     dtype=x.dtype, generator=g).contiguous(
                memory_format=torch.channels_last)
        wt = kernel.permute(3, 2, 0, 1).to(x.dtype).contiguous(
            memory_format=torch.channels_last)
        convs.append((inputs[ci], wt, k // 2))
    return lambda: [F.conv2d(inp, wt, padding=pad) for inp, wt, pad in convs]


def check_k2(csp_cuda, plain, x, folded, nb, packed, label):
    """K2 on x against its plain version, within K2_TOL_*; returns the
    errors. For bfloat16 also the share of elements more than one ulp
    apart, and both versions' mean |error| against float32."""
    got = csp_cuda.fused_csp_stage_cuda(x, folded, nb, packed)
    torch.cuda.synchronize()
    if (got.shape != x.shape or got.dtype != x.dtype
            or not bool(torch.isfinite(got).all())):
        raise AssertionError(f"K2 {label}: {got.dtype} {tuple(got.shape)}, "
                             f"finite {bool(torch.isfinite(got).all())}")
    want = plain(x, folded, nb).float()
    d = (got.float() - want).abs()
    res = dict(max_abs_err=float(d.max()),
               max_rel_err=float((d / (1 + want.abs())).max()))
    if x.dtype == torch.float32:
        ok = res["max_rel_err"] <= K2_TOL_F32
    else:
        ulp = torch.exp2(torch.floor(torch.log2(
            want.abs().clamp_min(2.0 ** -126))) - 7)
        res["ulp_share"] = float((d > ulp).float().mean())
        ref = plain(x.float(), folded, nb)
        res["mean_err_vs_f32"] = float((got.float() - ref).abs().mean())
        res["plain_mean_err_vs_f32"] = float((want - ref).abs().mean())
        ok = (res["max_rel_err"] <= K2_TOL_BF16
              and res["mean_err_vs_f32"]
              <= K2_TOL_BF16_VS_F32 * res["plain_mean_err_vs_f32"])
    log(f"[k2] {label}: " + ", ".join(f"{k} {v:.4g}" for k, v in res.items()))
    if not ok:
        raise AssertionError(f"K2 {label} outside its tolerance: {res}")
    return res


def phase_k2_cases(csp_cuda, plain, report):
    """K2 against its plain version on seeded inputs, float32 and
    bfloat16, at the stage shapes of 608/b16 and the ragged shapes."""
    rows = []
    with tf32_off(), torch.inference_mode():
        for i, (b, h, w, c, nb) in enumerate(STAGE_SHAPES + RAGGED_SHAPES):
            x, folded = k2_case(i, b, h, w, c, nb)
            for dt in (torch.float32, torch.bfloat16):
                res = check_k2(csp_cuda, plain, x.to(dt), folded, nb, None,
                               f"{str(dt)[6:]} {(b, h, w, c)} nb={nb}")
                rows.append(dict(shape=[b, h, w, c], num_blocks=nb,
                                 dtype=str(dt)[6:], **res))
            del x, folded
            torch.cuda.empty_cache()
    report["k2_cases"] = rows


def phase_fused(cfg_cls, build_model, Predictor, csp_cuda, plain,
                launch_plan, report):
    """The full-width 608/b16 bfloat16 forward with PALLAS_CSP on against
    the default path and a float32 forward of the same weights; each of
    stages 1-3 on its real input; then the Predictor with PALLAS_CSP on.
    Returns the per-stage K2 rows."""
    cfg = cfg_cls.from_dict({"MODEL": {"PALLAS_CSP": True}})
    batch, size = 16, cfg["TEST"]["IMGSIZE"]
    model = build_model(cfg, device="cuda",
                        generator=torch.Generator().manual_seed(3))
    model.load_state_dict(redraw_bn(model.state_dict(),
                                    np.random.default_rng(3)))
    model = model.eval().to(memory_format=torch.channels_last)
    bb = model.backbone
    stages = (bb.stage1, bb.stage2, bb.stage3)
    x = torch.rand((batch, 3, size, size), device="cuda",
                   generator=torch.Generator("cuda").manual_seed(4))
    x = x.contiguous(memory_format=torch.channels_last)
    plan_launches = sum(len(launch_plan(s.base.conv.out_channels,
                                        s.num_blocks)) for s in stages)
    with torch.inference_mode():
        csp_cuda.fused_csp_stage_cuda.launches = 0
        conv0 = csp_cuda.conv_launches()
        fused = model(x)
        torch.cuda.synchronize()
        launches = csp_cuda.fused_csp_stage_cuda.launches
        conv_launches = csp_cuda.conv_launches() - conv0
        if launches != 3 or conv_launches != plan_launches:
            raise AssertionError(f"K2 launched {launches} times and its conv "
                                 f"kernels {conv_launches} times in one "
                                 f"forward (plan: 3 and {plan_launches})")
        fused_ms = cuda_ms(lambda: model(x), iters=10)
        for stage in stages:
            stage.fused = False
        default = model(x)
        default_ms = cuda_ms(lambda: model(x), iters=10)
        for stage in stages:
            stage.fused = True
    ref = build_model(cfg_cls.from_dict({"MODEL": {"COMPUTE_DTYPE":
                                                   "float32"}}),
                      device="cuda")
    ref.load_state_dict(model.state_dict())
    ref = ref.eval().to(memory_format=torch.channels_last)
    with tf32_off(), torch.inference_mode():
        want = ref(x)
    del ref
    errs = {}
    for name, y in (("fused", fused), ("default", default)):
        if y.shape != want.shape or not bool(torch.isfinite(y).all()):
            raise AssertionError(f"{name} forward: {tuple(y.shape)}, finite "
                                 f"{bool(torch.isfinite(y).all())}")
        d = (y - want).abs()
        errs[name] = dict(score_mean=float(d[..., 4:].mean()),
                          score_max=float(d[..., 4:].max()),
                          box_mean_px=float(d[..., :4].mean()),
                          box_max_px=float(d[..., :4].max()))
    d = (fused - default).abs()
    direct = dict(score_mean=float(d[..., 4:].mean()),
                  score_max=float(d[..., 4:].max()),
                  box_mean_px=float(d[..., :4].mean()),
                  box_max_px=float(d[..., :4].max()),
                  score_std=float(want[..., 4:].std()))
    log(f"[fused] 608/b16 bf16, BN re-drawn: K2 launches {launches} per "
        f"forward, {conv_launches} conv kernel launches; vs float32: fused {errs['fused']}, default "
        f"{errs['default']}; fused vs default {direct}")
    for key in ("score_mean", "box_mean_px"):
        if errs["fused"][key] > FUSED_TOL_VS_F32 * errs["default"][key]:
            raise AssertionError(f"fused forward {key} error "
                                 f"{errs['fused'][key]} vs the default "
                                 f"path's {errs['default'][key]}")
    log(f"[fused] forward+decode ms per batch of {batch}: PALLAS_CSP "
        f"{fused_ms:.3f}, default {default_ms:.3f}")
    del fused, default, want

    per_stage = []
    with tf32_off(), torch.inference_mode():
        h = bb.stem(x.to(torch.bfloat16))
        for name, stage in zip(("stage1", "stage2", "stage3"), stages):
            xb = stage.base(h)
            nhwc = xb.permute(0, 2, 3, 1).contiguous()
            nb = stage.num_blocks
            folded, packed = stage.folded_weights(xb)
            res = check_k2(csp_cuda, plain, nhwc, folded, nb, packed,
                           f"{name} main-path input")
            conv0 = csp_cuda.conv_launches()
            csp_cuda.fused_csp_stage_cuda(nhwc, folded, nb, packed)
            n_conv = csp_cuda.conv_launches() - conv0
            n_plan = len(launch_plan(nhwc.shape[-1], nb))
            if n_conv != n_plan:
                raise AssertionError(f"K2 {name}: {n_conv} conv launches, "
                                     f"the plan has {n_plan}")
            ms = cuda_ms(lambda: csp_cuda.fused_csp_stage_cuda(
                nhwc, folded, nb, packed))
            device_ms = cuda_ms(lambda: csp_cuda.fused_csp_stage_cuda(
                nhwc, folded, nb, packed), queue_ahead=True)
            plain_ms = cuda_ms(lambda: plain(nhwc, folded, nb), iters=5)
            body_ms = cuda_ms(lambda: stage.body(xb))
            cudnn_ms = cuda_ms(cudnn_convs(nhwc, folded))
            bound_ms, bound_by = k2_bound(nhwc, folded)
            pbound_ms, pbound_by = plan_bound(nhwc, folded, nb, launch_plan)
            tflops = k2_ops(nhwc, folded) / (ms * 1e-3) / 1e12
            per_stage.append(dict(
                stage=name, shape=list(nhwc.shape), num_blocks=nb,
                conv_launches=n_conv, gemms=len(packed) // 2, ms=ms,
                device_ms=device_ms, plain_ms=plain_ms, default_body_ms=body_ms,
                cudnn_convs_ms=cudnn_ms, bound_ms=bound_ms,
                bound_by=bound_by, plan_bound_ms=pbound_ms,
                plan_bound_by=pbound_by, tflops=tflops, **res))
            log(f"[fused] {name} {tuple(nhwc.shape)} nb={nb}: K2 {ms:.4f} ms "
                f"(device {device_ms:.4f} ms) in {n_conv} conv launches "
                f"({tflops:.1f} TFLOP/s), plain "
                f"{plain_ms:.4f} ms, default body {body_ms:.4f} ms, cuDNN "
                f"convs alone {cudnn_ms:.4f} ms, bound {bound_ms:.4f} ms by "
                f"{bound_by}, plan bound {pbound_ms:.4f} ms by {pbound_by}")
            h = csp_cuda.fused_csp_stage_cuda(nhwc, folded, nb,
                                              packed).permute(0, 3, 1, 2)
    del model
    torch.cuda.empty_cache()

    # the detection path of phase 3 with PALLAS_CSP on, measured alike
    pred = Predictor(cfg, img_size=size, batch_size=batch, device="cuda")
    rng = np.random.default_rng(0)
    images = [rng.integers(0, 256, (batch, size, size, 3), dtype=np.uint8)
              for _ in range(4)]
    pred.warmup()
    pred(images[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for imgs in images:
        pred(imgs)
    e2e_img_s = batch * len(images) / (time.perf_counter() - t0)
    xin = pred.upload(images[0])
    run_ms = cuda_ms(lambda: pred.run(xin), iters=10)
    log(f"[fused] Predictor with PALLAS_CSP: normalize+fwd+NMS {run_ms:.3f} "
        f"ms per batch ({batch * 1e3 / run_ms:.1f} img/s), e2e "
        f"{e2e_img_s:.2f} img/s (host clock, upload to fetch)")
    report["fused"] = dict(launches=launches, conv_launches=conv_launches,
                           fwd_ms=fused_ms,
                           default_fwd_ms=default_ms, run_ms=run_ms,
                           device_img_s=batch * 1e3 / run_ms,
                           e2e_img_s=e2e_img_s, vs_f32=errs,
                           vs_default=direct, stages=per_stage)
    del pred
    torch.cuda.empty_cache()
    return per_stage


def write_val2017(work, coco_ids, n_images=32, name="val2017", seed=7):
    """A synthetic COCO split (val2017 unless ``name`` says otherwise) of
    mixed-size JPEGs with 1-4 filled boxes each."""
    import cv2
    img_dir = work / "images" / name
    img_dir.mkdir(parents=True)
    (work / "annotations").mkdir(exist_ok=True)
    rng = np.random.default_rng(seed)
    sizes = ((480, 640), (640, 480), (375, 500), (608, 608), (427, 640),
             (720, 1280), (333, 500), (512, 384))
    images, anns = [], []
    for i in range(n_images):
        h, w = sizes[i % len(sizes)]
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        for _ in range(int(rng.integers(1, 5))):
            bw, bh = rng.uniform(20, w / 2), rng.uniform(20, h / 2)
            x0, y0 = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
            cv2.rectangle(img, (int(x0), int(y0)), (int(x0 + bw),
                                                    int(y0 + bh)),
                          tuple(int(v) for v in rng.integers(0, 256, 3)), -1)
            anns.append({"id": len(anns) + 1, "image_id": i + 1,
                         "category_id": int(coco_ids[rng.integers(0, 80)]),
                         "bbox": [x0, y0, bw, bh], "area": bw * bh,
                         "iscrowd": 0})
        file_name = f"{i + 1:012}.jpg"
        if not cv2.imwrite(str(img_dir / file_name), img):
            raise OSError("cannot write a test JPEG")
        images.append({"id": i + 1, "file_name": file_name, "height": h,
                       "width": w})
    with open(work / "annotations" / f"instances_{name}.json", "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": [{"id": c, "name": str(c)}
                                  for c in coco_ids]}, f)


def phase_val(val_mod, coco_ids, nms_cuda, csp_cuda, report):
    """``python -m yolov4_tpu_torch.val`` at full width with PALLAS_CSP on;
    returns K2's launches in it."""
    work = ROOT / "runs" / "chip_smoke_val"
    shutil.rmtree(work, ignore_errors=True)
    n_images, batch = 32, 16
    write_val2017(work, coco_ids, n_images)
    cfg_path = work / "val.cfg"
    cfg_path.write_text("MODEL:\n  PALLAS_CSP: true\n")
    nms_cuda.greedy_nms_mask_cuda.launches = 0
    csp_cuda.fused_csp_stage_cuda.launches = 0
    t0 = time.time()
    ap, ap50 = val_mod.main([str(work), "-c", str(cfg_path), "--batch-size",
                             str(batch), "--conf-thre", "0.001"])
    seconds = time.time() - t0
    k1 = nms_cuda.greedy_nms_mask_cuda.launches
    k2 = csp_cuda.fused_csp_stage_cuda.launches
    n_batches = n_images // batch
    if not (np.isfinite(ap) and np.isfinite(ap50) and 0.0 <= ap <= ap50 <= 1.0):
        raise AssertionError(f"val: AP {ap}, AP50 {ap50}")
    if k1 != n_batches or k2 != 3 * n_batches:
        raise AssertionError(f"val: K1 launched {k1}, K2 {k2} times in "
                             f"{n_batches} batches")
    log(f"[val] {n_images} images at full width, PALLAS_CSP on, batch "
        f"{batch}, conf 0.001: AP {ap:.5f}, AP50 {ap50:.5f}; K1 {k1}, K2 {k2} "
        f"launches in {n_batches} batches; {seconds:.1f}s")
    report["val"] = dict(images=n_images, batches=n_batches, ap=ap, ap50=ap50,
                         k1_launches=k1, k2_launches=k2, seconds=seconds)
    shutil.rmtree(work, ignore_errors=True)
    return k2


def small_train_batches(device):
    """Two batches at 128x128, batch 4: images from a seed, three boxes per
    image on three different scales (so that no two share an anchor cell,
    where the written box would depend on the device's write order)."""
    rng = np.random.default_rng(11)
    out = []
    for _ in range(2):
        imgs = torch.from_numpy(rng.random((4, 128, 128, 3),
                                           dtype=np.float32))
        labels = np.zeros((4, 60, 5), np.float32)
        for b in range(4):
            cx, cy = rng.uniform(30, 98, 2)
            labels[b, 0] = [cx, cy, 14, 18, rng.integers(80)]     # stride 8
            labels[b, 1] = [128 - cx, cy, 60, 50, rng.integers(80)]
            labels[b, 2] = [64, 64, 120, 110, rng.integers(80)]  # stride 32
        out.append((imgs.to(device), torch.from_numpy(labels).to(device)))
    return out


def train_two_steps(cfg, build_model, train, device, seed, dtype):
    """Two SGD micro-steps (ACCUMULATION_STEPS 2) of the WIDTH 0.25 model
    from init ``seed`` on ``device`` in ``dtype``: (losses, initial
    state_dict, final state_dict), on the CPU."""
    model = build_model(cfg, device=device, train=True,
                        generator=torch.Generator().manual_seed(seed))
    model = model.to(dtype)
    init = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    step = train.make_train_step(
        model, train.build_criterion(cfg), train.build_optimizer(cfg, model),
        train.build_lr_schedule(cfg, len_epoch=4), accumulation_steps=2)
    state = train.create_train_state(model)
    losses = []
    for imgs, labels in small_train_batches(device):
        state = step(state, imgs.to(dtype), labels)
        losses.append(float(state.loss))
    return losses, init, {k: v.detach().cpu() for k, v in
                          model.state_dict().items()}


def compare_train_runs(cpu, gpu, param_names):
    """The card's run against the CPU's: the losses' largest relative gap;
    the parameters' change as the L2 norm of the difference over the L2
    norm of the CPU's change, and the worst tensor's largest difference
    over its largest change; for each BN buffer its largest difference,
    absolute and over the buffer's largest magnitude; other buffers must
    be equal."""
    (cpu_loss, init, cpu_sd), (gpu_loss, _, gpu_sd) = cpu, gpu
    diff2 = ref2 = 0.0
    res = dict(card_loss=gpu_loss, cpu_loss=cpu_loss, worst_tensor_rel=0.0,
               worst_tensor="", worst_buffer_abs=0.0, worst_buffer_rel=0.0,
               unequal=[])
    for key, want in cpu_sd.items():
        got = gpu_sd[key]
        if key in param_names:
            upd_want = (want - init[key]).double()
            upd_diff = (got - init[key]).double() - upd_want
            diff2 += float(upd_diff.square().sum())
            ref2 += float(upd_want.square().sum())
            rel = float(upd_diff.abs().max() / upd_want.abs().max())
            if rel > res["worst_tensor_rel"]:
                res["worst_tensor_rel"], res["worst_tensor"] = rel, key
        elif key.endswith(("running_mean", "running_var")):
            d = float((got - want).abs().max())
            res["worst_buffer_abs"] = max(res["worst_buffer_abs"], d)
            res["worst_buffer_rel"] = max(res["worst_buffer_rel"],
                                          d / float(want.abs().max()))
        elif not torch.equal(got, want):
            res["unequal"].append(key)
    res["update_l2_rel"] = (diff2 / ref2) ** 0.5
    res["loss_rel"] = float(np.max(np.abs(np.subtract(gpu_loss, cpu_loss))
                                   / np.abs(cpu_loss)))
    return res


def phase_train_vs_cpu(cfg_cls, build_model, train, report):
    """The train step at WIDTH 0.25 on the card (TF32 off) against the
    CPU, SGD, ACCUMULATION_STEPS 2, two micro-steps from one init seed: in
    float32 at TRAIN_SEED (TRAIN_TOL_*), then in float64 at init seeds 1
    and 5 (TRAIN_F64_TOL_*)."""
    cfg = cfg_cls.from_dict({
        "MODEL": {"WIDTH": 0.25, "DEPTH": 0.25, "COMPUTE_DTYPE": "float32"},
        "OPTIMIZER": {"TYPE": "SGD", "LR": 0.01},
        "TRAIN": {"ACCUMULATION_STEPS": 2}})
    params = dict(build_model(cfg, device="cpu").named_parameters())
    with tf32_off():
        runs = {dev: train_two_steps(cfg, build_model, train, dev, TRAIN_SEED,
                                     torch.float32)
                for dev in ("cpu", "cuda")}
    res = compare_train_runs(runs["cpu"], runs["cuda"], params)
    rtol, atol = TRAIN_TOL_BUF
    bad = list(res["unequal"])
    for key, want in runs["cpu"][2].items():
        if (key.endswith(("running_mean", "running_var"))
                and not torch.allclose(runs["cuda"][2][key], want,
                                       rtol=rtol, atol=atol)):
            bad.append(key)
    log(f"[train] WIDTH 0.25 f32 at 128, batch 4, SGD, 2 micro-steps, init "
        f"seed {TRAIN_SEED}: card vs CPU loss {res['card_loss']} vs "
        f"{res['cpu_loss']} ({res['loss_rel']:.3g} apart, tol "
        f"{TRAIN_TOL_LOSS}); parameter change {res['update_l2_rel']:.3g} "
        f"apart in L2 (tol {TRAIN_TOL_UPDATE_L2}), worst tensor "
        f"{res['worst_tensor']} {res['worst_tensor_rel']:.3g} of its largest "
        f"change (tol {TRAIN_TOL_UPDATE_TENSOR}); worst BN buffer |diff| "
        f"{res['worst_buffer_abs']:.3g}")
    if (res["loss_rel"] > TRAIN_TOL_LOSS
            or not res["update_l2_rel"] <= TRAIN_TOL_UPDATE_L2
            or res["worst_tensor_rel"] > TRAIN_TOL_UPDATE_TENSOR or bad):
        raise AssertionError(f"train step on the card against the CPU out "
                             f"of tolerance (buffers off: {bad})")
    report["train_vs_cpu"] = {k: res[k] for k in (
        "card_loss", "cpu_loss", "update_l2_rel", "worst_tensor_rel",
        "worst_buffer_abs")}

    f64 = {}
    for seed in TRAIN_F64_SEEDS:
        runs = {dev: train_two_steps(cfg, build_model, train, dev, seed,
                                     torch.float64)
                for dev in ("cpu", "cuda")}
        res = compare_train_runs(runs["cpu"], runs["cuda"], params)
        log(f"[train] WIDTH 0.25 f64 at 128, init seed {seed}: card vs CPU "
            f"loss {res['card_loss']} vs {res['cpu_loss']} "
            f"({res['loss_rel']:.3g} apart, tol {TRAIN_F64_TOL_LOSS}); "
            f"parameter change {res['update_l2_rel']:.3g} apart in L2, "
            f"worst tensor {res['worst_tensor']} {res['worst_tensor_rel']:.3g}"
            f" of its largest change (tol {TRAIN_F64_TOL_UPDATE_TENSOR}); "
            f"worst BN buffer |diff| {res['worst_buffer_abs']:.3g}, "
            f"{res['worst_buffer_rel']:.3g} of its largest magnitude (tol "
            f"{TRAIN_F64_TOL_BUF})")
        if (res["loss_rel"] > TRAIN_F64_TOL_LOSS
                or res["worst_tensor_rel"] > TRAIN_F64_TOL_UPDATE_TENSOR
                or res["worst_buffer_rel"] > TRAIN_F64_TOL_BUF
                or res["unequal"]):
            raise AssertionError(f"float64 train step on the card against "
                                 f"the CPU out of tolerance at init seed "
                                 f"{seed}: {res}")
        f64[seed] = {k: res[k] for k in (
            "card_loss", "cpu_loss", "loss_rel", "update_l2_rel",
            "worst_tensor", "worst_tensor_rel", "worst_buffer_abs",
            "worst_buffer_rel")}
    report["train_vs_cpu_f64"] = f64


def phase_train_full(cfg_cls, build_model, train, report):
    """The full-width train step at 608/b8, bfloat16 autocast over float32
    weights, Adam: timed, then a fresh model's loss over 30 steps."""
    from yolov4_tpu_torch.tools.profile_train import (forward_conv_flops,
                                                      random_batch)
    batch, size = 8, 608
    cfg = cfg_cls.from_dict({
        "DATA": {"BATCH_SIZE": batch},
        "MODEL": {"COMPUTE_DTYPE": "bfloat16"},
        "OPTIMIZER": {"TYPE": "ADAM"},
        "LR_SCHEDULER": {"IS_WARMUP": False}})
    images, labels = random_batch(batch, size, seed=2, device="cuda")

    def build(seed):
        model = build_model(cfg, device="cuda", train=True,
                            generator=torch.Generator().manual_seed(seed))
        model = model.to(memory_format=torch.channels_last)
        step = train.make_train_step(
            model, train.build_criterion(cfg),
            train.build_optimizer(cfg, model),
            train.build_lr_schedule(cfg, len_epoch=100),
            accumulation_steps=1, compute_dtype=torch.bfloat16)
        return model, step, train.create_train_state(model)

    model, step, state = build(0)
    params = sum(p.numel() for p in model.parameters())
    flops = 3.0 * forward_conv_flops(model, train.images_to_input(images))
    for _ in range(3):
        state = step(state, images, labels)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n = 20
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        state = step(state, images, labels)
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / n
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    share = flops / (step_ms * 1e-3) / PEAK_BF16_OPS
    log(f"[train full] YOLOv4 {params:,} params, 608/b{batch}, bf16 "
        f"autocast, f32 weights, Adam: {step_ms:.3f} ms per step "
        f"({batch * 1e3 / step_ms:.1f} img/s), peak memory "
        f"{peak_gib:.2f} GiB, {flops / 1e12:.3f} TFLOP per step "
        f"({share:.2%} of the bf16 dense peak)")
    del model, step, state
    torch.cuda.empty_cache()

    model, step, state = build(1)
    losses = []
    for _ in range(30):
        state = step(state, images, labels)
        losses.append(float(state.loss))
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"train loss over 30 steps: {losses}")
    log(f"[train full] 30 steps on one batch, no warmup: loss "
        f"{' '.join(f'{v:.2f}' for v in losses)}")
    del model, step, state
    torch.cuda.empty_cache()
    report["train_full"] = dict(
        params=params, batch=batch, img_size=size, step_ms=step_ms,
        img_s=batch * 1e3 / step_ms, peak_memory_gib=peak_gib,
        train_tflop=flops / 1e12, flop_share_bf16=share, losses=losses)


def fit_trainer(Trainer, raw, work, kernels, resume=None, hook=None):
    """``Trainer.fit`` from the config dict ``raw`` on the synthetic COCO
    in ``work``, with K1's and K2's counts set to 0 just before and read
    just after; ``hook(trainer)`` runs before fit. Returns (trainer, K1
    launches, K2 launches, the run's metrics records)."""
    from yolov4_tpu_torch.config import Config
    nms_cuda, csp_cuda = kernels
    trainer = Trainer(Config.from_dict(raw), str(work), resume=resume,
                      device="cuda", print_freq=4)
    if hook is not None:
        hook(trainer)
    nms_cuda.greedy_nms_mask_cuda.launches = 0
    csp_cuda.fused_csp_stage_cuda.launches = 0
    trainer.fit()
    k1 = nms_cuda.greedy_nms_mask_cuda.launches
    k2 = csp_cuda.fused_csp_stage_cuda.launches
    with open(Path(raw["TRAIN"]["OUTPUT_DIR"]) / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    return trainer, k1, k2, rows


def record_losses(trainer, losses):
    """Append each micro-step's loss (a device scalar: no host sync) to
    ``losses``."""
    step = trainer.train_step

    def recording(state, images, labels):
        state = step(state, images, labels)
        losses.append(state.loss)
        return state

    trainer.train_step = recording


def phase_trainer(Trainer, nms_cuda, csp_cuda, coco_ids, report):
    """``Trainer.fit`` at full width on one synthetic COCO three ways: host
    augmentation with 4 and with 8 loader workers, and
    AUGMENTATION.DEVICE; resumes from a checkpoint in the first and the
    last. Returns {run: (K1, K2) launches}, each run's counts set to 0
    just before it and read just after."""
    work = ROOT / "runs" / "chip_smoke_train"
    shutil.rmtree(work, ignore_errors=True)
    n_train, n_val, batch, epochs = 64, 16, 8, 2
    steps, n_val_batches = n_train // batch, n_val // batch
    write_val2017(work, coco_ids, n_train, name="train2017", seed=8)
    write_val2017(work, coco_ids, n_val, name="val2017", seed=9)
    kernels = (nms_cuda, csp_cuda)

    def config(name, workers, device_aug, max_epochs=epochs):
        return {"DATA": {"BATCH_SIZE": batch, "WORKERS": workers},
                "MODEL": {"PALLAS_CSP": True},
                "AUGMENTATION": {"IS_MOSAIC": True, "DEVICE": device_aug},
                "TEST": {"BATCH_SIZE": batch},
                "TRAIN": {"ACCUMULATION_STEPS": 2, "MAX_EPOCHS": max_epochs,
                          "OUTPUT_DIR": str(work / name)}}

    def check(name, trainer, k1, k2, rows, n_epochs, first_step=0):
        losses = [r["loss"] for r in rows if r["kind"] == "train"]
        epoch_rows = [r for r in rows if r["kind"] == "train_epoch"]
        if (k1 != n_epochs * n_val_batches
                or k2 != 3 * n_epochs * n_val_batches):
            raise AssertionError(f"Trainer ({name}): K1 launched {k1}, K2 "
                                 f"{k2} times in {n_epochs} validations of "
                                 f"{n_val_batches} batches")
        if trainer.state.step != first_step + n_epochs * steps:
            raise AssertionError(f"Trainer ({name}) took "
                                 f"{trainer.state.step - first_step} steps")
        if not np.isfinite(losses).all() or len(epoch_rows) != n_epochs:
            raise AssertionError(f"Trainer ({name}) records: {rows}")
        return [r["img_s"] for r in epoch_rows]

    runs, img_s, launches = {}, {}, {}
    # host augmentation, 4 workers, then a resume for a third epoch
    t0 = time.time()
    raw = config("host4", 4, False)
    trainer, k1, k2, rows = fit_trainer(Trainer, raw, work, kernels)
    fit_s = time.time() - t0
    img_s["host4"] = check("host, 4 workers", trainer, k1, k2, rows, epochs)
    launches["host4"] = (k1, k2)
    best_ap50 = trainer.best_ap50
    del trainer
    torch.cuda.empty_cache()
    raw = config("host4", 4, False, epochs + 1)
    carried = []

    def carry(t):
        carried.extend((t.start_epoch, t.state.step, t.best_ap50))

    resumed, k1, k2, rows = fit_trainer(
        Trainer, raw, work, kernels,
        resume=str(work / "host4" / "checkpoint.pth"), hook=carry)
    if tuple(carried) != (epochs, epochs * steps, best_ap50):
        raise AssertionError(f"resume carried (epoch, step, best AP50) "
                             f"{carried}, expected "
                             f"{(epochs, epochs * steps, best_ap50)}")
    img_s["host4"] += check("host, 4 workers, resumed", resumed, k1, k2,
                            rows[-4:], 1, first_step=epochs * steps)
    launches["host4_resumed"] = (k1, k2)
    evals = [r["ap50"] for r in rows if r["kind"] == "eval"]
    del resumed
    torch.cuda.empty_cache()

    # host augmentation, 8 workers
    trainer, k1, k2, rows = fit_trainer(Trainer, config("host8", 8, False),
                                        work, kernels)
    img_s["host8"] = check("host, 8 workers", trainer, k1, k2, rows, epochs)
    launches["host8"] = (k1, k2)
    del trainer
    torch.cuda.empty_cache()

    # AUGMENTATION.DEVICE: 2 epochs keeping the checkpoint of the first,
    # then a resume from it, whose first steps must see the same
    # augmented batches and so give the same losses
    out = work / "device"
    first_ckpt = out / "epoch1.pth"
    losses = []

    def keep_first(t):
        record_losses(t, losses)
        save = t.save

        def saving(epoch, ap50, ap):
            save(epoch, ap50, ap)
            if epoch == 0:
                shutil.copyfile(out / "checkpoint.pth", first_ckpt)

        t.save = saving

    t0 = time.time()
    trainer, k1, k2, rows = fit_trainer(Trainer, config("device", 4, True),
                                        work, kernels, hook=keep_first)
    device_fit_s = time.time() - t0
    img_s["device"] = check("AUGMENTATION.DEVICE", trainer, k1, k2, rows,
                            epochs)
    launches["device"] = (k1, k2)
    del trainer
    torch.cuda.empty_cache()
    again = []
    resumed, k1, k2, rows = fit_trainer(
        Trainer, config("device", 4, True), work, kernels,
        resume=str(first_ckpt), hook=lambda t: record_losses(t, again))
    check("AUGMENTATION.DEVICE, resumed", resumed, k1, k2, rows[-4:], 1,
          first_step=steps)
    launches["device_resumed"] = (k1, k2)
    del resumed
    torch.cuda.empty_cache()
    losses = [float(v) for v in losses]
    again = [float(v) for v in again]
    # the first two steps after the resume run at the checkpoint's weights
    # (ACCUMULATION_STEPS 2): the same batches give the same losses
    resume_rel = max(abs(a - b) / abs(b)
                     for a, b in zip(again[:2], losses[steps:steps + 2]))
    epoch_rel = max(abs(a - b) / abs(b)
                    for a, b in zip(again, losses[steps:]))
    if not np.isfinite(losses).all() or resume_rel > RESUME_TOL:
        raise AssertionError(f"device-aug resume: losses {again[:2]} after "
                             f"the resume, {losses[steps:steps + 2]} in the "
                             f"uninterrupted run")
    log(f"[trainer] full width, 608, batch {batch}, mosaic, ACCUMULATION_"
        f"STEPS 2, PALLAS_CSP val, 2 epochs each: host augmentation 4 "
        f"workers in {fit_s:.1f}s, then resumed at epoch {carried[0] + 1} "
        f"step {carried[1]} best AP50 {carried[2]} for a third; host 8 "
        f"workers; AUGMENTATION.DEVICE (4 workers) in {device_fit_s:.1f}s, "
        f"then resumed from its epoch-1 checkpoint: the first two losses "
        f"{again[:2]} against {losses[steps:steps + 2]} uninterrupted "
        f"({resume_rel:.3g} apart, tol {RESUME_TOL}; {epoch_rel:.3g} over "
        f"the epoch). K1, K2 launches per run {launches}; AP50 per epoch "
        f"(host 4) {evals}")
    log(f"[trainer] Trainer img/s per epoch (loader included): host 4 "
        f"workers {[round(v, 2) for v in img_s['host4']]}, host 8 workers "
        f"{[round(v, 2) for v in img_s['host8']]}, AUGMENTATION.DEVICE "
        f"{[round(v, 2) for v in img_s['device']]}")
    report["trainer"] = dict(fit_seconds=fit_s, device_fit_seconds=device_fit_s,
                             epoch_img_s=img_s, launches=launches,
                             resumed_from=carried, ap50=evals,
                             device_losses=losses, device_resumed_losses=again,
                             device_resume_rel=resume_rel)
    shutil.rmtree(work, ignore_errors=True)
    return launches


def aug_case(seed, b, size, k=60):
    """Member canvases [B, 4, S, S, 3] uint8 (noise under filled
    rectangles) and member boxes [B, 4, K, 5] (1-20 per member, in canvas
    pixels), on the CPU."""
    import cv2
    rng = np.random.default_rng(seed)
    canvases = rng.integers(0, 256, (b, 4, size, size, 3), dtype=np.uint8)
    boxes = np.zeros((b, 4, k, 5), np.float32)
    for i in range(b):
        for m in range(4):
            n = int(rng.integers(1, 21))
            xy = rng.uniform(0, size * 0.9, (n, 2))
            wh = rng.uniform(4, size * 0.5, (n, 2))
            boxes[i, m, :n, :2] = xy
            boxes[i, m, :n, 2:4] = np.minimum(xy + wh, size)
            boxes[i, m, :n, 4] = rng.integers(0, 80, n)
            for x1, y1, x2, y2 in boxes[i, m, :n, :4].astype(int)[:4]:
                cv2.rectangle(canvases[i, m], (int(x1), int(y1)),
                              (int(x2), int(y2)),
                              tuple(int(v) for v in rng.integers(0, 256, 3)),
                              -1)
    return torch.from_numpy(canvases), torch.from_numpy(boxes)


def phase_device_aug(cfg_cls, build_model, train, report):
    """AUGMENTATION.DEVICE's augmentation (data/device_aug.py) on the card:
    the same parameters, drawn on the CPU, applied on the card and on the
    CPU at 608/b2 (AUG_TOL_*); two calls with one (seed, step) equal, and
    no host synchronisation in a call; augment_batch timed at 608/b8, and
    the full-width train step with it inside beside the step on the same
    batch already augmented."""
    from yolov4_tpu_torch.data import device_aug as da
    from yolov4_tpu_torch.parallel.train_step import aug_generator
    cfg = cfg_cls.from_dict({
        "DATA": {"BATCH_SIZE": 8}, "MODEL": {"COMPUTE_DTYPE": "bfloat16"},
        "OPTIMIZER": {"TYPE": "ADAM"}, "LR_SCHEDULER": {"IS_WARMUP": False},
        "AUGMENTATION": {"DEVICE": True}})
    kw = da.device_aug_config(cfg)
    size, k = 608, cfg["DATA"]["MAX_NUM_LABELS"]
    cases = []
    for seed in range(3):
        canvases, boxes = aug_case(seed, 2, size, k)
        params = da.sample_params(torch.Generator().manual_seed(seed), 2,
                                  size, **kw)
        want_img, want_lab = da.apply_params(canvases, boxes, params, k)
        got_img, got_lab = da.apply_params(
            canvases.cuda(), boxes.cuda(),
            {n: v.cuda() for n, v in params.items()}, k)
        got_img, got_lab = got_img.cpu(), got_lab.cpu()
        img_err = float((got_img - want_img).abs().max())
        box_err = float((got_lab - want_lab).abs().max())
        same_rows = torch.equal(got_lab.sum(-1) > 0, want_lab.sum(-1) > 0)
        cases.append(dict(seed=seed, img_max_abs=img_err,
                          box_max_abs_px=box_err, rows_equal=same_rows,
                          labels=int((want_lab.sum(-1) > 0).sum()),
                          flips=int(params["flip"].sum()),
                          zoom_out_members=int((params["crop"] < 0).any(-1)
                                               .sum())))
        if (img_err > AUG_TOL_IMG or box_err > AUG_TOL_BOX_PX
                or not same_rows or got_img.shape != (2, size, size, 3)):
            raise AssertionError(f"device aug on the card against the CPU: "
                                 f"{cases[-1]}")
    log(f"[aug] 608/b2, parameters drawn on the CPU, applied on the card "
        f"and on the CPU: {cases} (tol {AUG_TOL_IMG} on [0, 1], "
        f"{AUG_TOL_BOX_PX} px, label rows equal)")

    b = 8
    canvases, boxes = aug_case(7, b, size, k)
    canvases, boxes = canvases.cuda(), boxes.cuda()

    def call(step):
        return da.augment_batch(aug_generator(canvases.device, 0, step),
                                canvases, boxes, size, k, **kw)

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        first = call(5)
        second = call(5)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    other = call(6)
    if not (torch.equal(first[0], second[0])
            and torch.equal(first[1], second[1])):
        raise AssertionError("device aug: one (seed, step) gave two outputs")
    if torch.equal(first[0], other[0]):
        raise AssertionError("device aug: steps 5 and 6 gave one output")
    ms = cuda_ms(lambda: call(5))
    device_ms = cuda_ms(lambda: call(5), queue_ahead=True)
    # the dense resample's products: 2 x (N x S x S x 3S) multiply-adds
    gflop = 2 * 2 * (b * 4) * size * size * 3 * size / 1e9
    log(f"[aug] augment_batch 608/b{b}: {ms:.3f} ms per call with the "
        f"host's enqueue, device {device_ms:.3f} ms; equal for one (seed, "
        f"step), no host synchronisation; resample products {gflop:.1f} "
        f"GFLOP float32")

    model = build_model(cfg, device="cuda", train=True,
                        generator=torch.Generator().manual_seed(0))
    model = model.to(memory_format=torch.channels_last)
    opt = train.build_optimizer(cfg, model)
    common = dict(accumulation_steps=1, compute_dtype=torch.bfloat16)
    crit = train.build_criterion(cfg)
    sched = train.build_lr_schedule(cfg, len_epoch=100)
    step_aug = train.make_train_step(model, crit, opt, sched,
                                     device_aug=kw, **common)
    step_plain = train.make_train_step(model, crit, opt, sched, **common)
    state = train.create_train_state(model)
    images, labels = call(5)

    def timed(fn, *args, n=10):
        nonlocal state
        for _ in range(2):
            state = fn(state, *args)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            state = fn(state, *args)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / n

    aug_step_ms = timed(step_aug, canvases, boxes)
    plain_step_ms = timed(step_plain, images, labels)
    if not bool(torch.isfinite(state.loss)):
        raise AssertionError(f"train step with device aug: loss {state.loss}")
    log(f"[aug] full-width train step 608/b{b}, bf16 autocast, Adam: "
        f"{aug_step_ms:.3f} ms with augment_batch inside "
        f"({b * 1e3 / aug_step_ms:.1f} img/s), {plain_step_ms:.3f} ms on the "
        f"same batch already augmented")
    del model, opt, step_aug, step_plain, state
    torch.cuda.empty_cache()
    report["device_aug"] = dict(cases=cases, batch=b, img_size=size,
                                augment_ms=ms, augment_device_ms=device_ms,
                                resample_gflop=gflop, step_ms=aug_step_ms,
                                step_plain_ms=plain_step_ms)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    from yolov4_tpu_torch import detect as detect_mod
    from yolov4_tpu_torch import val as val_mod
    from yolov4_tpu_torch.config import Config, load_config
    from yolov4_tpu_torch.data.coco import COCO_CLASS_IDS
    from yolov4_tpu_torch.engine.predictor import Predictor
    from yolov4_tpu_torch.engine.trainer import Trainer
    from yolov4_tpu_torch.models import build_model
    from yolov4_tpu_torch.ops import csp_cuda, nms_cuda
    from yolov4_tpu_torch.ops import postprocess as postprocess_mod
    from yolov4_tpu_torch.ops.csp import (fused_csp_stage_plain,
                                          kernel_widths, launch_plan)
    from yolov4_tpu_torch.ops.loss import build_criterion
    from yolov4_tpu_torch.ops.nms import greedy_nms_mask
    from yolov4_tpu_torch.optim import build_lr_schedule, build_optimizer
    from yolov4_tpu_torch.parallel.train_step import (create_train_state,
                                                      images_to_input,
                                                      make_train_step)

    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    report = {}
    build_kernels([nms_cuda, csp_cuda], report)
    k1_build_report(nms_cuda, report)
    k2_build_report(csp_cuda, kernel_widths, report)

    err = phase_kernel_cases(nms_cuda, greedy_nms_mask, report)

    cfg = load_config(None)
    captured, launches = phase_main(cfg, nms_cuda, postprocess_mod,
                                    Predictor, report)
    k1 = time_k1(nms_cuda, greedy_nms_mask, *captured[0])
    k1["suppressed"] = time_k1_suppressed(nms_cuda, greedy_nms_mask)
    report["k1"] = k1

    phase_device_vs_cpu(Config, build_model, report)
    phase_detect(detect_mod, nms_cuda, report)
    phase_k2_cases(csp_cuda, fused_csp_stage_plain, report)
    stages = phase_fused(Config, build_model, Predictor, csp_cuda,
                         fused_csp_stage_plain, launch_plan, report)
    k2_launches = phase_val(val_mod, COCO_CLASS_IDS, nms_cuda, csp_cuda,
                            report)
    train = SimpleNamespace(
        build_criterion=build_criterion, build_optimizer=build_optimizer,
        build_lr_schedule=build_lr_schedule, make_train_step=make_train_step,
        create_train_state=create_train_state, images_to_input=images_to_input)
    phase_train_vs_cpu(Config, build_model, train, report)
    phase_train_full(Config, build_model, train, report)
    trainer_launches = phase_trainer(Trainer, nms_cuda, csp_cuda,
                                     COCO_CLASS_IDS, report)
    trainer_k1 = sum(k1 for k1, _ in trainer_launches.values())
    trainer_k2 = sum(k2 for _, k2 in trainer_launches.values())
    device_k1, device_k2 = (sum(trainer_launches[run][i]
                                for run in ("device", "device_resumed"))
                            for i in (0, 1))
    phase_device_aug(Config, build_model, train, report)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    kernels = {"kernels": [{
        "name": "greedy_nms_mask",
        "route": "cuda",
        "source": "yolov4_tpu_torch/csrc/nms.cu",
        "replaces": "yolov4_tpu/ops/nms_pallas.py:140",
        # the detection path's batches and the Trainer's validations (the
        # three Trainer runs and their resumes; of them, the runs with
        # AUGMENTATION.DEVICE)
        "launches": launches + trainer_k1,
        "launches_in_trainer": trainer_k1,
        "launches_in_device_aug_trainer": device_k1,
        "max_abs_err": err,
        "ms": k1["ms"],
        "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"],
        "library_ms": k1["library_ms"],
        # device times (a spin kernel queued ahead); ms and ms_suppressed
        # include the host's enqueue
        "device_ms": k1["device_ms"],
        "mask_ms": k1["mask_ms"],
        "scan_ms": k1["scan_ms"],
        "ms_suppressed": k1["suppressed"]["ms"],
        "device_ms_suppressed": k1["suppressed"]["device_ms"],
    }, {
        # one entry for the three stage bodies of a forward: times and
        # bounds are their sums, per_stage holds each
        "name": "fused_csp_stage",
        "route": "cuda",
        "source": "yolov4_tpu_torch/csrc/csp.cu",
        "replaces": "yolov4_tpu/ops/csp_pallas.py:344",
        # val's batches and the Trainer's validations
        "launches": k2_launches + trainer_k2,
        "launches_in_trainer": trainer_k2,
        "launches_in_device_aug_trainer": device_k2,
        "max_abs_err": max(r["max_abs_err"] for r in stages),
        "ms": sum(r["ms"] for r in stages),
        "device_ms": sum(r["device_ms"] for r in stages),
        "plain_ms": sum(r["plain_ms"] for r in stages),
        "bound_ms": sum(r["bound_ms"] for r in stages),
        "bound_by": "operations" if all(r["bound_by"] == "operations"
                                        for r in stages) else "bytes",
        "library_ms": None,
        "library_note": "no single PyTorch call computes a CSP stage body; "
                        "default_body_ms is the layer-by-layer path, "
                        "cudnn_convs_ms cuDNN's convolutions alone",
        "default_body_ms": sum(r["default_body_ms"] for r in stages),
        "conv_launches_per_forward": sum(r["conv_launches"] for r in stages),
        "cudnn_convs_ms": sum(r["cudnn_convs_ms"] for r in stages),
        "plan_bound_ms": sum(r["plan_bound_ms"] for r in stages),
        "per_stage": stages,
    }]}
    print(json.dumps({"report": report}))
    print(smi)
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
