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
               1e-9 of its largest, BN buffers within 1e-10), each against
               a CPU run that a second run repeats bit for bit (a third
               when they differ, REFERENCE_RUNS).
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
 12. ddp     — data parallelism (parallel/dist.py): two ranks on the one
               card over gloo (spawned, LOCAL_RANK 0 each), float64, WIDTH
               0.25 at 128, batch 4 per rank, SGD, ACCUMULATION_STEPS 2,
               two micro-steps, against the same two ranks on the CPU
               (TRAIN_F64_TOL_*; REFERENCE_RUNS as in 9), the ranks'
               parameters equal, the BN statistics the mean of each
               rank's one-process run (per replica, averaged); NCCL at world
               size 1, full width 608/b8 bf16 Adam: the DDP-wrapped step
               against the plain step from one init (two updates; the
               largest parameter gap, beside a second plain run's), both
               timed with CUDA events; ``torchrun --nproc_per_node 1 -m
               yolov4_tpu_torch.train`` for one epoch with PALLAS_CSP val
               (checkpoint, metrics.jsonl, K1/K2 counted in its eval
               record); ``Trainer.fit`` in two ranks on the one card over
               gloo with an odd val2017 (the wrap-padded image scored once):
               equal AP and parameters, files from rank 0 only, K1 and K2
               in each rank's validation. NCCL above one rank needs more
               than one card and is not run.

 13. serve   — the serving path (run after phase 8): K2 at the three
               416/b16 stage shapes of the second bucket against its plain
               version (float32 and bfloat16, phase 6's tolerances), the
               bfloat16 calls timed; a ServingRuntime with buckets 608 and
               416 at batch 16 sharing one full-width bf16 PALLAS_CSP
               model (seed-0 init, BN re-drawn as in phase 7) behind the
               HTTP server on 127.0.0.1 (port 0): 480 requests from 48
               client threads, JPEGs to /v1/detect and raw frames to
               /v1/detect_raw alternating, both buckets, per-request conf
               none / 0.3 / 0.5; every response equal, in its detections,
               to the rows the direct Predictor gives for the same canvas
               in the same batch (a row can depend on its batchmates
               through the NMS's class-offset span), K1 once, K2 3 times
               and its conv kernels 14 times per batch served; requests/s,
               e2e and queue latency p50/p99, mean batch fill; the 608
               bucket exported (utils/export.py), reloaded bit-identical
               to the live predictor, and served from the artifact
               (ServingRuntime.from_artifacts): the same checks and
               counts; ``python -m yolov4_tpu_torch.detect`` on a 20-frame
               cv2-written clip.

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
# The CPU reference of each float64 gate is run until two of its runs agree
# bit for bit, at most this many times. The CPU run is deterministic (the
# same bits on every repeat, under load too), so a run that differs from
# the others is a fault of the host, not a reference: one such
# run on an H100 machine's host read its first micro-step's loss 687 ulps
# off and a BN bias's change 5.8e-9 off, while the card's numbers equalled
# every other run's to the bit. The card runs once and is held to the
# agreed reference with the tolerances above.
REFERENCE_RUNS = 3
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
# Phase 12 (data parallel): each group of spawned ranks, and the torchrun
# run, must end within this many seconds; its synthetic COCO.
DDP_LIMIT_S = 600
DDP_TRAIN_IMAGES = 32
DDP_VAL_IMAGES = 17
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


def small_train_batches(device, seed=11):
    """Two batches at 128x128, batch 4: images from a seed, three boxes per
    image on three different scales (so that no two share an anchor cell,
    where the written box would depend on the device's write order)."""
    rng = np.random.default_rng(seed)
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


def train_two_steps(cfg, build_model, train, device, seed, dtype,
                    batch_seed=11, dist=None):
    """Two SGD micro-steps (ACCUMULATION_STEPS 2) of the WIDTH 0.25 model
    from init ``seed`` on ``device`` in ``dtype`` (data-parallel over the
    process group ``dist`` when given) on small_train_batches(batch_seed):
    (losses, initial state_dict, final state_dict), on the CPU."""
    model = build_model(cfg, device=device, train=True,
                        generator=torch.Generator().manual_seed(seed))
    model = model.to(dtype)
    init = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    step = train.make_train_step(
        model, train.build_criterion(cfg), train.build_optimizer(cfg, model),
        train.build_lr_schedule(cfg, len_epoch=4), accumulation_steps=2,
        dist=dist)
    state = train.create_train_state(model)
    losses = []
    for imgs, labels in small_train_batches(device, batch_seed):
        state = step(state, imgs.to(dtype), labels)
        losses.append(float(state.loss))
    return losses, init, {k: v.detach().cpu() for k, v in
                          model.state_dict().items()}


def same_train_run(a, b) -> bool:
    """Two train_two_steps results equal bit for bit."""
    return a[0] == b[0] and all(
        all(torch.equal(v, y[k]) for k, v in x.items())
        for x, y in ((a[1], b[1]), (a[2], b[2])))


def agreed_cpu_run(run, group=None):
    """The CPU reference ``run()`` of a float64 gate, run until two of its
    runs agree bit for bit (REFERENCE_RUNS at most): (that result, the
    number of runs). Over the process group ``group`` the ranks decide
    together, so that each makes as many runs (and collectives) as the
    others. Raises when no two runs agree."""
    import torch.distributed as tdist
    runs = [run(), run()]
    while True:
        agreed = next((a for i, a in enumerate(runs) for b in runs[i + 1:]
                       if same_train_run(a, b)), None)
        ok = agreed is not None
        if group is not None:
            flag = torch.tensor([int(ok)])
            tdist.all_reduce(flag, op=tdist.ReduceOp.MIN, group=group)
            ok = bool(flag.item())
        if ok:
            return agreed, len(runs)
        if len(runs) == REFERENCE_RUNS:
            raise AssertionError(f"the CPU reference gave {len(runs)} "
                                 f"different results: {[r[0] for r in runs]}")
        runs.append(run())


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
    and 5 (TRAIN_F64_TOL_*, against agreed_cpu_run)."""
    cfg = small_train_cfg(cfg_cls)
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
        cpu, cpu_runs = agreed_cpu_run(lambda: train_two_steps(
            cfg, build_model, train, "cpu", seed, torch.float64))
        res = compare_train_runs(cpu, train_two_steps(
            cfg, build_model, train, "cuda", seed, torch.float64), params)
        res["cpu_runs"] = cpu_runs
        log(f"[train] WIDTH 0.25 f64 at 128, init seed {seed}: card vs CPU "
            f"(its runs until two agree: {cpu_runs}) "
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
            "worst_buffer_rel", "cpu_runs")}
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


def train_api():
    """The port's training functions phases 9-12 drive."""
    from yolov4_tpu_torch.ops.loss import build_criterion
    from yolov4_tpu_torch.optim import build_lr_schedule, build_optimizer
    from yolov4_tpu_torch.parallel.train_step import (create_train_state,
                                                      images_to_input,
                                                      make_train_step)
    return SimpleNamespace(
        build_criterion=build_criterion, build_optimizer=build_optimizer,
        build_lr_schedule=build_lr_schedule, make_train_step=make_train_step,
        create_train_state=create_train_state, images_to_input=images_to_input)


def small_train_cfg(cfg_cls):
    """Phase 9's configuration: WIDTH 0.25, SGD, ACCUMULATION_STEPS 2."""
    return cfg_cls.from_dict({
        "MODEL": {"WIDTH": 0.25, "DEPTH": 0.25, "COMPUTE_DTYPE": "float32"},
        "OPTIMIZER": {"TYPE": "SGD", "LR": 0.01},
        "TRAIN": {"ACCUMULATION_STEPS": 2}})


def ddp_f64_task(rank):
    """Phase 12.1 on one rank: two float64 micro-steps over the group on
    the card, then on the CPU (agreed_cpu_run), each on this rank's own
    batches; and the same two on the card without the group ("alone")."""
    from yolov4_tpu_torch.config import Config
    from yolov4_tpu_torch.models import build_model
    from yolov4_tpu_torch.parallel import dist
    cfg, train = small_train_cfg(Config), train_api()
    out = {"cuda": train_two_steps(cfg, build_model, train, "cuda",
                                   TRAIN_SEED, torch.float64,
                                   batch_seed=11 + rank,
                                   dist=dist.world_group())}
    out["cpu"], out["cpu_runs"] = agreed_cpu_run(
        lambda: train_two_steps(cfg, build_model, train, "cpu", TRAIN_SEED,
                                torch.float64, batch_seed=11 + rank,
                                dist=dist.world_group()),
        group=dist.world_group())
    out["alone"] = train_two_steps(cfg, build_model, train, "cuda",
                                   TRAIN_SEED, torch.float64,
                                   batch_seed=11 + rank)
    return out


def params_digest(model) -> str:
    import hashlib
    digest = hashlib.sha256()
    for t in (*model.parameters(), *model.buffers()):
        digest.update(t.detach().cpu().contiguous().numpy().tobytes())
    return digest.hexdigest()


def ddp_fit_task(rank, root, raw):
    """Phase 12.4 on one rank: Trainer.fit with OUTPUT_DIR fit_r<rank> and
    the CLI's logging, K1's and K2's counts set to 0 just before and read
    just after."""
    from yolov4_tpu_torch.config import Config
    from yolov4_tpu_torch.engine.trainer import Trainer
    from yolov4_tpu_torch.ops import csp_cuda, nms_cuda
    from yolov4_tpu_torch.utils.logging import setup_logging
    raw = {k: dict(v) for k, v in raw.items()}
    raw["TRAIN"]["OUTPUT_DIR"] = str(Path(root) / f"fit_r{rank}")
    setup_logging(process_index=rank, output_dir=raw["TRAIN"]["OUTPUT_DIR"])
    trainer = Trainer(Config.from_dict(raw), root, device="cuda",
                      print_freq=1)
    nms_cuda.greedy_nms_mask_cuda.launches = 0
    csp_cuda.fused_csp_stage_cuda.launches = 0
    ap, ap50 = trainer.fit()
    return {"ap": ap, "ap50": ap50, "step": trainer.state.step,
            "k1": nms_cuda.greedy_nms_mask_cuda.launches,
            "k2": csp_cuda.fused_csp_stage_cuda.launches,
            "device": str(trainer.device),
            "digest": params_digest(trainer.model)}


DDP_TASKS = {"f64": ddp_f64_task, "fit": ddp_fit_task}


def ddp_rank(rank, world, init_file, tasks, work):
    """Target of phase 12's spawned ranks: rank ``rank`` of ``world``, each
    on the one card (LOCAL_RANK 0, as one process per node), in a gloo
    group that meets through ``init_file``; runs each (name, kwargs) of
    ``tasks`` in turn and saves what it returns, with its seconds, to
    ``<work>/<name>.rank<rank>.pt``."""
    import os
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK="0")
    from yolov4_tpu_torch.parallel import dist
    dist.init_distributed(backend="gloo", device="cuda",
                          init_method=f"file://{init_file}",
                          timeout_s=DDP_LIMIT_S)
    try:
        for name, kwargs in tasks:
            t0 = time.time()
            result = DDP_TASKS[name](rank, **kwargs)
            result["seconds"] = time.time() - t0
            torch.save(result, Path(work) / f"{name}.rank{rank}.pt")
    finally:
        dist.shutdown()


def start_ranks(tasks, work, world=2):
    """``world`` spawned ranks running ``tasks`` (ddp_rank), started."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=ddp_rank, args=(
        r, world, str(work / "rendezvous.ranks"), tasks, str(work)))
        for r in range(world)]
    for p in procs:
        p.start()
    return procs


def join_ranks(procs, tasks, work, deadline):
    """Join the ranks by ``deadline`` (time.monotonic), killing any left;
    returns {task: [each rank's result]}."""
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0.0))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(30)
    codes = [p.exitcode for p in procs]
    if hung or codes != [0] * len(procs):
        raise AssertionError(f"ddp ranks {hung} hung, exit codes {codes}")
    return {name: [torch.load(work / f"{name}.rank{r}.pt", weights_only=True)
                   for r in range(len(procs))] for name, _ in tasks}


def check_ddp_f64(ranks, cfg_cls, build_model, report):
    """12.1: two ranks on the one card over gloo against the same two
    ranks on the CPU, float64, within TRAIN_F64_TOL_*; the ranks'
    parameters and BN buffers equal after the update; the BN statistics
    the mean of the ranks' one-process runs."""
    params = dict(build_model(small_train_cfg(cfg_cls),
                              device="cpu").named_parameters())
    res = []
    for rank, out in enumerate(ranks):
        r = compare_train_runs(out["cpu"], out["cuda"], params)
        if (r["loss_rel"] > TRAIN_F64_TOL_LOSS
                or r["worst_tensor_rel"] > TRAIN_F64_TOL_UPDATE_TENSOR
                or r["worst_buffer_rel"] > TRAIN_F64_TOL_BUF
                or r["unequal"]):
            raise AssertionError(f"two-rank float64 step, rank {rank}: card "
                                 f"against CPU out of tolerance: {r}")
        res.append({k: r[k] for k in (
            "card_loss", "cpu_loss", "loss_rel", "update_l2_rel",
            "worst_tensor", "worst_tensor_rel", "worst_buffer_rel")})
        res[-1]["cpu_runs"] = out["cpu_runs"]
    for dev in ("cuda", "cpu"):
        final = [out[dev][2] for out in ranks]
        unequal = [k for k, v in final[0].items()
                   if not torch.equal(v, final[1][k])]
        if unequal:
            raise AssertionError(f"two-rank float64 step on {dev}: ranks "
                                 f"differ in {unequal[:5]}")
    # per-replica BN: the running statistics are linear in the batch
    # statistics, and these do not depend on them in train mode, so after
    # the two micro-steps (no update between their forwards) they are the
    # mean of the ranks' one-process runs; rank 0's (a buffer broadcast)
    # or the whole batch's (SyncBN) would differ
    bn_rel = 0.0
    for key, got in ranks[0]["cuda"][2].items():
        if key.endswith(("running_mean", "running_var")):
            want = (ranks[0]["alone"][2][key] + ranks[1]["alone"][2][key]) / 2
            bn_rel = max(bn_rel, float((got - want).abs().max()
                                       / want.abs().max()))
    if bn_rel > TRAIN_F64_TOL_BUF:
        raise AssertionError(f"two-rank BN statistics {bn_rel} from the mean "
                             f"of the ranks' one-process runs")
    seconds = max(r["seconds"] for r in ranks)
    log(f"[ddp] 2 ranks on the one card over gloo, WIDTH 0.25 f64 at 128, "
        f"batch 4 per rank, SGD, 2 micro-steps, against the same 2 ranks on "
        f"the CPU (its runs until two agree: "
        f"{[r['cpu_runs'] for r in res]}): loss "
        f"{[r['loss_rel'] for r in res]} apart (tol "
        f"{TRAIN_F64_TOL_LOSS}), worst tensor "
        f"{[r['worst_tensor_rel'] for r in res]} of its largest change (tol "
        f"{TRAIN_F64_TOL_UPDATE_TENSOR}), BN buffers "
        f"{[r['worst_buffer_rel'] for r in res]} (tol {TRAIN_F64_TOL_BUF}); "
        f"the ranks' parameters and buffers equal; BN statistics "
        f"{bn_rel:.3g} from the mean of the ranks' one-process runs (tol "
        f"{TRAIN_F64_TOL_BUF}); {seconds:.1f}s")
    report["ddp_f64"] = {"ranks": res, "bn_vs_mean_of_alone": bn_rel,
                         "seconds": seconds}


def phase_ddp_nccl(cfg_cls, build_model, train, work, smi, report):
    """12.2: NCCL at world size 1, full width, 608/b8, bf16 autocast, Adam:
    the DDP-wrapped step against the plain step from one init on one batch,
    two updates each, and a second plain run for the run-to-run gap; then
    both timed with CUDA events, 20 steps each in turns of 10 (plain, DDP,
    DDP, plain)."""
    import os
    from yolov4_tpu_torch.parallel import dist
    from yolov4_tpu_torch.tools.profile_train import random_batch
    batch, size = 8, 608
    cfg = cfg_cls.from_dict({
        "DATA": {"BATCH_SIZE": batch},
        "MODEL": {"COMPUTE_DTYPE": "bfloat16"},
        "OPTIMIZER": {"TYPE": "ADAM"},
        "LR_SCHEDULER": {"IS_WARMUP": False}})
    images, labels = random_batch(batch, size, seed=2, device="cuda")

    def build(ddp):
        model = build_model(cfg, device="cuda", train=True,
                            generator=torch.Generator().manual_seed(0))
        model = model.to(memory_format=torch.channels_last)
        step = train.make_train_step(
            model, train.build_criterion(cfg),
            train.build_optimizer(cfg, model),
            train.build_lr_schedule(cfg, len_epoch=100),
            accumulation_steps=1, compute_dtype=torch.bfloat16,
            dist=dist.world_group() if ddp else None)
        state = train.create_train_state(model)
        losses = []
        for _ in range(2):
            state = step(state, images, labels)
            losses.append(float(state.loss))
        return SimpleNamespace(model=model, step=step, state=state,
                               losses=losses)

    def gap(a, b):
        return max(float((p - q).detach().abs().max())
                   for p, q in zip(a.model.parameters(), b.model.parameters()))

    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0")
    dist.init_distributed(backend="nccl", device="cuda",
                          init_method=f"file://{work / 'rendezvous.nccl'}",
                          timeout_s=DDP_LIMIT_S)
    try:
        runs = {"plain": build(False), "ddp": build(True)}
        again = build(False)
        ddp_gap, rerun_gap = gap(runs["ddp"], runs["plain"]), gap(
            again, runs["plain"])
        losses = {k: r.losses for k, r in runs.items()}
        del again
        for r in runs.values():
            for _ in range(3):
                r.state = r.step(r.state, images, labels)
        torch.cuda.synchronize()
        times = {"plain": [], "ddp": []}
        for name in ("plain", "ddp", "ddp", "plain"):
            r = runs[name]
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(10):
                r.state = r.step(r.state, images, labels)
            end.record()
            torch.cuda.synchronize()
            times[name].append(start.elapsed_time(end) / 10)
    finally:
        dist.shutdown()
        for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
            os.environ.pop(key, None)
    del runs
    torch.cuda.empty_cache()
    plain_ms, ddp_ms = (float(np.mean(times[k])) for k in ("plain", "ddp"))
    bit_equal = ddp_gap == 0.0 and losses["ddp"] == losses["plain"]
    log(f"[ddp] NCCL world size 1, full width 608/b{batch} bf16 Adam, 2 "
        f"updates from one init on one batch: DDP against the plain step "
        f"{'bit-equal' if bit_equal else 'not bit-equal'}, largest parameter "
        f"gap {ddp_gap:.3g} (a second plain run against the first: "
        f"{rerun_gap:.3g}); losses {losses}")
    log(f"[ddp] {smi}: step {plain_ms:.3f} ms plain, {ddp_ms:.3f} ms with "
        f"DDP (turns of 10 steps: plain {times['plain']}, DDP "
        f"{times['ddp']}); DDP's cost {ddp_ms - plain_ms:.3f} ms per step")
    report["ddp_nccl"] = dict(bit_equal=bit_equal, ddp_gap=ddp_gap,
                              rerun_gap=rerun_gap, losses=losses,
                              plain_ms=plain_ms, ddp_ms=ddp_ms,
                              turns_ms=times)


def ddp_coco(work, coco_ids):
    """Phase 12's synthetic COCO: 32 train2017 JPEGs and 17 val2017 ones
    (odd: two ranks' shards wrap one image)."""
    write_val2017(work, coco_ids, DDP_TRAIN_IMAGES, name="train2017", seed=8)
    write_val2017(work, coco_ids, DDP_VAL_IMAGES, name="val2017", seed=9)


def ddp_trainer_cfg(out_dir=""):
    """12.3's and 12.4's configuration: full width, 608, batch 8 a rank,
    mosaic, ACCUMULATION_STEPS 2, one epoch, PALLAS_CSP validation."""
    return {"DATA": {"BATCH_SIZE": 8, "WORKERS": 2},
            "MODEL": {"PALLAS_CSP": True},
            "AUGMENTATION": {"IS_MOSAIC": True},
            "TEST": {"BATCH_SIZE": 8},
            "TRAIN": {"ACCUMULATION_STEPS": 2, "MAX_EPOCHS": 1,
                      "OUTPUT_DIR": out_dir}}


def start_cli(work):
    """12.3: start ``torchrun --standalone --nproc_per_node 1 -m
    yolov4_tpu_torch.train`` (NCCL) for one epoch at full width with
    PALLAS_CSP validation, its output to cli.log."""
    import os
    import yaml
    with open(work / "cli.yaml", "w") as f:
        yaml.safe_dump(ddp_trainer_cfg(str(work / "cli")), f)
    logf = open(work / "cli.log", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "1", "-m", "yolov4_tpu_torch.train",
         str(work), "-c", str(work / "cli.yaml"), "--print-freq", "2"],
        cwd=ROOT, stdout=logf, stderr=subprocess.STDOUT,
        env=dict(os.environ))
    logf.close()
    return proc, time.time()


def wait_cli(cli, deadline):
    """Wait for the torchrun run by ``deadline`` (time.monotonic), killing
    it after; returns (exit code, seconds)."""
    proc, t0 = cli
    try:
        rc = proc.wait(timeout=max(deadline - time.monotonic(), 1.0))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(30)
        rc = None
    return rc, time.time() - t0


def check_ddp_cli(work, rc, seconds, report):
    """12.3's checks: exit code 0, checkpoint.pth and metrics.jsonl
    written, and K1 and K2 counted in its eval record. Returns (K1, K2)."""
    import os
    out = work / "cli"
    tail = (work / "cli.log").read_text()[-3000:]
    if rc != 0:
        raise AssertionError(f"torchrun train exited {rc} after "
                             f"{seconds:.1f}s:\n{tail}")
    with open(out / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    evals = [r for r in rows if r["kind"] == "eval"]
    n_val = -(-DDP_VAL_IMAGES // 8)
    want = {"greedy_nms_mask": n_val, "fused_csp_stage": 3 * n_val}
    if (not (out / "checkpoint.pth").exists() or len(evals) != 1
            or evals[0]["launches"] != want):
        raise AssertionError(f"torchrun train wrote {sorted(os.listdir(out))}"
                             f", eval records {evals} (K1/K2 launches "
                             f"expected {want})\n{tail}")
    log(f"[ddp] torchrun --nproc_per_node 1 -m yolov4_tpu_torch.train "
        f"(NCCL), full width, 1 epoch of {DDP_TRAIN_IMAGES} images, "
        f"PALLAS_CSP val of {DDP_VAL_IMAGES}: {seconds:.1f}s, AP50 "
        f"{evals[0]['ap50']}, launches {evals[0]['launches']}, wrote "
        f"{sorted(os.listdir(out))}")
    report["ddp_cli"] = {"seconds": seconds, "eval": evals[0]}
    return want["greedy_nms_mask"], want["fused_csp_stage"]


def check_ddp_fit(ranks, work, report):
    """12.4's checks: Trainer.fit in two ranks on the one card over gloo,
    full width: equal AP and parameters on both, files from rank 0 only,
    K1 and K2 launched in each rank's validation. Returns (K1, K2)
    launches over both ranks."""
    per_rank = -(-DDP_VAL_IMAGES // 2)       # wrap-padded shard
    n_val = -(-per_rank // 8)                # each rank's val batches
    r0, r1 = ranks
    written = sorted(p.name for p in (work / "fit_r0").iterdir())
    bad = []
    if (r0["ap"], r0["ap50"]) != (r1["ap"], r1["ap50"]):
        bad.append("AP differs")
    if r0["digest"] != r1["digest"]:
        bad.append("parameters differ")
    if not {"checkpoint.pth", "metrics.jsonl", "stdout.log"} <= set(written):
        bad.append(f"rank 0 wrote {written}")
    if (work / "fit_r1").exists():
        bad.append("rank 1 wrote files")
    for r in ranks:
        if (r["k1"], r["k2"]) != (n_val, 3 * n_val):
            bad.append(f"K1/K2 launched {r['k1']}/{r['k2']} times")
    if bad:
        raise AssertionError(f"two-rank Trainer.fit: {bad}")
    seconds = max(r["seconds"] for r in ranks)
    log(f"[ddp] Trainer.fit in 2 ranks on the one card over gloo, full "
        f"width, batch 8 per rank, 1 epoch: {seconds:.1f}s, AP {r0['ap']} "
        f"AP50 {r0['ap50']} on both, devices {[r['device'] for r in ranks]},"
        f" K1/K2 per rank {[(r['k1'], r['k2']) for r in ranks]}, rank 0 "
        f"wrote {written}, rank 1 nothing")
    report["ddp_fit"] = {"seconds": seconds, "ap": r0["ap"],
                         "ap50": r0["ap50"],
                         "launches": [(r["k1"], r["k2"]) for r in ranks]}
    return sum(r["k1"] for r in ranks), sum(r["k2"] for r in ranks)


def phase_ddp(cfg_cls, build_model, train, coco_ids, smi, report):
    """Phase 12: 12.2 alone (it is timed), then the torchrun run (12.3)
    beside one group of two spawned ranks that runs 12.1 and then 12.4.
    Returns {run: (K1, K2) launches}, each run's counts set to 0 just
    before it and read just after, in its processes."""
    import os
    work = ROOT / "runs" / "chip_smoke_ddp"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    t0 = time.time()
    # one machine: the groups' sockets stay on the loopback interface
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    phase_ddp_nccl(cfg_cls, build_model, train, work, smi, report)
    ddp_coco(work, coco_ids)
    tasks = [("f64", {}),
             ("fit", {"root": str(work), "raw": ddp_trainer_cfg()})]
    deadline = time.monotonic() + DDP_LIMIT_S
    cli = start_cli(work)
    try:
        ranks = join_ranks(start_ranks(tasks, work), tasks, work, deadline)
    finally:
        rc, cli_s = wait_cli(cli, deadline)
    check_ddp_f64(ranks["f64"], cfg_cls, build_model, report)
    launches = {"cli": check_ddp_cli(work, rc, cli_s, report),
                "fit": check_ddp_fit(ranks["fit"], work, report)}
    report["ddp_seconds"] = time.time() - t0
    log(f"[ddp] phase 12 in {report['ddp_seconds']:.1f}s")
    shutil.rmtree(work, ignore_errors=True)
    return launches


SERVE_SHAPES = ((16, 208, 208, 64, 0), (16, 104, 104, 128, 2),
                (16, 52, 52, 256, 8))      # K2's stages at 416/b16
SERVE_SIZES = (608, 416)
SERVE_CLIENTS = 48         # client threads, each with one request in flight
SERVE_REQUESTS = 480       # live runtime; the artifact runtime serves
SERVE_ARTIFACT_REQUESTS = 96   # this many from the exported 608 bucket
SERVE_CONFS = (None, 0.3, 0.5)  # per-request post-NMS filters (bucket 0.25)
VIDEO_FRAMES = 20


def phase_k2_416(csp_cuda, plain, report):
    """K2 at the three 416/b16 stage shapes of the serving runtime's second
    bucket (new to K2) against its plain version, float32 and bfloat16,
    with phase 6's tolerances; the bfloat16 calls timed."""
    from yolov4_tpu_torch.ops.csp import pack_weights
    rows = []
    with tf32_off(), torch.inference_mode():
        for i, (b, h, w, c, nb) in enumerate(SERVE_SHAPES):
            x, folded = k2_case(100 + i, b, h, w, c, nb)
            for dt in (torch.float32, torch.bfloat16):
                xd = x.to(dt)
                packed = [t.to(x.device) for t in pack_weights(folded, nb, dt)]
                res = check_k2(csp_cuda, plain, xd, folded, nb, packed,
                               f"416 {str(dt)[6:]} {(b, h, w, c)} nb={nb}")
                row = dict(shape=[b, h, w, c], num_blocks=nb,
                           dtype=str(dt)[6:], **res)
                if dt == torch.bfloat16:
                    row["ms"] = cuda_ms(lambda: csp_cuda.fused_csp_stage_cuda(
                        xd, folded, nb, packed))
                    row["device_ms"] = cuda_ms(
                        lambda: csp_cuda.fused_csp_stage_cuda(
                            xd, folded, nb, packed), queue_ahead=True)
                    row["bound_ms"], row["bound_by"] = k2_bound(xd, folded)
                    log(f"[serve] K2 416 stage {(b, h, w, c)} nb={nb}: "
                        f"{row['ms']:.4f} ms (device {row['device_ms']:.4f}), "
                        f"bound {row['bound_ms']:.4f} ms by {row['bound_by']}")
                rows.append(row)
            del x, folded
            torch.cuda.empty_cache()
    report["serve_k2_416"] = rows


def serve_images(seed, n):
    """n synthetic BGR images of mixed sizes with filled rectangles."""
    import cv2
    rng = np.random.default_rng(seed)
    shapes = [(480, 640), (720, 1280), (375, 500), (608, 608), (416, 416)]
    out = []
    for i in range(n):
        h, w = shapes[i % len(shapes)]
        yy, xx = np.mgrid[0:h, 0:w]
        img = np.stack([(xx * 255 // w), (yy * 255 // h),
                        rng.integers(0, 256, (h, w))], -1).astype(np.uint8)
        for _ in range(3):
            x0, y0 = int(rng.integers(0, w // 2)), int(rng.integers(0, h // 2))
            color = tuple(int(v) for v in rng.integers(0, 256, 3))
            cv2.rectangle(img, (x0, y0), (x0 + w // 3, y0 + h // 3), color,
                          -1)
        out.append(img)
    return out


def serve_requests(n, seed):
    """(kind, size, conf, image, body, query) for n requests: JPEG and raw
    frames alternating, both buckets, mixed per-request conf."""
    import cv2
    reqs = []
    for i, img in enumerate(serve_images(seed, n)):
        size = SERVE_SIZES[(i // 2) % 2]
        conf = SERVE_CONFS[i % 3]
        query = f"size={size}" + ("" if conf is None else f"&conf={conf}")
        if i % 2 == 0:
            ok, jpeg = cv2.imencode(".jpg", img)
            if not ok:
                raise OSError("cannot encode a test JPEG")
            # the server decodes the same bytes with the same library
            reqs.append(("detect", size, conf,
                         cv2.imdecode(jpeg, cv2.IMREAD_COLOR),
                         jpeg.tobytes(), query))
        else:
            h, w = img.shape[:2]
            reqs.append(("detect_raw", size, conf, img, img.tobytes(),
                         f"{query}&h={h}&w={w}"))
    return reqs


def post_all(base, reqs):
    """Every request POSTed from SERVE_CLIENTS threads; (bodies, seconds)."""
    import urllib.request

    def post(req):
        kind, _, _, _, body, query = req
        r = urllib.request.Request(f"{base}/v1/{kind}?{query}", data=body,
                                   method="POST")
        with urllib.request.urlopen(r, timeout=300) as resp:
            if resp.status != 200:
                raise AssertionError(f"HTTP {resp.status}")
            return json.loads(resp.read())

    t0 = time.perf_counter()
    with ThreadPoolExecutor(SERVE_CLIENTS) as pool:
        futs = [pool.submit(post, r) for r in reqs]
        bodies = [f.result(timeout=600) for f in futs]
    return bodies, time.perf_counter() - t0


class BatchLog:
    """Installed as a predictor's ``dispatch``: keeps every batch of
    canvases the batcher dispatches, as it was composed. A row's
    detections may depend on its batchmates (the class-offset span of the
    NMS is the batch's largest coordinate, as in the JAX package's
    postprocess), so the direct predictor is held to the served rows on
    the same batches. The batcher stacks a fresh array for every batch and
    never writes it after dispatch, so the log keeps a reference (a list
    append, atomic under the GIL) and adds no copy to the timed traffic."""

    def __init__(self, predictor):
        self.dispatch = predictor.dispatch
        self.batches = []
        predictor.dispatch = self

    def __call__(self, images):
        self.batches.append(images)
        return self.dispatch(images)


def expected_responses(runtime, predictor, batches, reqs):
    """The response each request should get: the rows that ``predictor``
    (direct, no batcher) gives for the request's canvas in the batch it
    was served in, through the same post-NMS filter and unmapping as the
    batcher, as result_to_json renders them."""
    import hashlib
    from yolov4_tpu_torch.ops.boxes import unmap_to_source_xyxy
    from yolov4_tpu_torch.serve import DetectionResult, result_to_json

    def key(canvas):
        return hashlib.sha1(canvas.tobytes()).hexdigest()

    rows = {}
    for batch in batches:
        dets, valid = predictor(batch)
        for canvas, d, v in zip(batch, dets, valid):
            rows[key(canvas)] = d[v]
    out = []
    for req in reqs:
        canvas, info = runtime.preprocess(req[3], req[1])
        d = rows[key(canvas)]
        scores = d[:, 4] * d[:, 5]
        if req[2] is not None:
            d, scores = d[scores >= req[2]], scores[scores >= req[2]]
        boxes = (np.asarray(unmap_to_source_xyxy(
            d[:, :4], info[:2], info[2:4], info[4:6]), np.float32)
            if d.shape[0] else np.zeros((0, 4), np.float32))
        out.append(result_to_json(DetectionResult(
            boxes=boxes, scores=scores.astype(np.float32),
            class_ids=d[:, 6].astype(np.int32), img_size=req[1])))
    return out


def check_responses(bodies, reqs, wants, label):
    """Every response's detections equal the direct predictor's."""
    n_dets = 0
    for body, req, want in zip(bodies, reqs, wants):
        if (body["img_size"] != want["img_size"]
                or body["detections"] != want["detections"]):
            raise AssertionError(f"{label}: the {req[0]} response for size "
                                 f"{req[1]} conf {req[2]} differs from the "
                                 f"direct predictor's rows")
        n_dets += body["num_detections"]
    if n_dets == 0:
        raise AssertionError(f"{label}: no detection in any response")
    return n_dets


def serve_metrics(runtime, n, seconds):
    lat = runtime.metrics.snapshot()["latency"]
    counters = runtime.metrics.snapshot()["counters"]
    return dict(requests=n, seconds=seconds, requests_per_s=n / seconds,
                e2e_p50_ms=lat["e2e_ms"]["p50"],
                e2e_p99_ms=lat["e2e_ms"]["p99"],
                queue_p50_ms=lat["queue_ms"]["p50"],
                queue_p99_ms=lat["queue_ms"]["p99"],
                batch_ms_p50=lat["batch_ms"]["p50"],
                mean_batch_fill=lat["batch_fill"]["mean_window"],
                batches=counters["batches_total"],
                errors=counters["errors_total"])


def run_traffic(runtime, reqs, kernels, label):
    """Serve ``reqs`` over HTTP on 127.0.0.1 (port 0) with K1's and K2's
    counts set to 0 just before and read just after; (bodies, metrics,
    K1, K2, K2 conv launches)."""
    from yolov4_tpu_torch.serve import make_server, serve_background
    nms_cuda, csp_cuda = kernels
    srv = make_server(runtime, host="127.0.0.1", port=0)
    thread = serve_background(srv)
    try:
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        nms_cuda.greedy_nms_mask_cuda.launches = 0
        csp_cuda.fused_csp_stage_cuda.launches = 0
        conv0 = csp_cuda.conv_launches()
        bodies, seconds = post_all(base, reqs)
        torch.cuda.synchronize()
        k1 = nms_cuda.greedy_nms_mask_cuda.launches
        k2 = csp_cuda.fused_csp_stage_cuda.launches
        conv = csp_cuda.conv_launches() - conv0
    finally:
        srv.shutdown()
        thread.join(60)
        srv.server_close()
    m = serve_metrics(runtime, len(reqs), seconds)
    if m["errors"]:
        raise AssertionError(f"{label}: {m['errors']} errors")
    log(f"[serve] {label}: {len(reqs)} requests from {SERVE_CLIENTS} "
        f"clients in {seconds:.2f}s: {m['requests_per_s']:.1f} requests/s, "
        f"e2e p50 {m['e2e_p50_ms']:.1f} / p99 {m['e2e_p99_ms']:.1f} ms, "
        f"queue p50 {m['queue_p50_ms']:.1f} / p99 {m['queue_p99_ms']:.1f} "
        f"ms, batch p50 {m['batch_ms_p50']:.1f} ms, mean batch fill "
        f"{m['mean_batch_fill']:.3f}, {m['batches']} batches; K1 {k1}, K2 "
        f"{k2}, K2 conv launches {conv}")
    return bodies, m, k1, k2, conv


def write_video(path, n, hw=(360, 480)):
    """A cv2-written synthetic clip (mp4v, else MJPG in .avi); its path."""
    import cv2
    for fourcc, ext in (("mp4v", ".mp4"), ("MJPG", ".avi")):
        p = path.with_suffix(ext)
        w = cv2.VideoWriter(str(p), cv2.VideoWriter_fourcc(*fourcc), 10.0,
                            (hw[1], hw[0]))
        if not w.isOpened():
            continue
        rng = np.random.default_rng(0)
        for i in range(n):
            frame = rng.integers(0, 255, (*hw, 3), np.uint8)
            cv2.rectangle(frame, (20 + 4 * i, 40), (200 + 4 * i, 200),
                          (0, 0, 255), -1)
            w.write(frame)
        w.release()
        return p
    raise AssertionError("no cv2 video encoder (mp4v, MJPG) to write a clip")


def phase_video(detect_mod, kernels, report, work):
    """``python -m yolov4_tpu_torch.detect``'s entry point on a synthetic
    clip: every frame written annotated, K1 once per batch of 8, and K2
    never (detect's default cfg has ``MODEL.PALLAS_CSP`` false)."""
    import cv2
    nms_cuda, csp_cuda = kernels
    src = write_video(work / "clip", VIDEO_FRAMES)
    nms_cuda.greedy_nms_mask_cuda.launches = 0
    csp_cuda.fused_csp_stage_cuda.launches = 0
    t0 = time.time()
    dest = detect_mod.main(["--source", str(src), "--dest",
                            str(work / "video_out"), "--batch-size", "8"])
    seconds = time.time() - t0
    launched = nms_cuda.greedy_nms_mask_cuda.launches
    k2_launched = csp_cuda.fused_csp_stage_cuda.launches
    outs = list(dest.iterdir())
    if len(outs) != 1:
        raise AssertionError(f"detect on a video wrote {outs}")
    cap = cv2.VideoCapture(str(outs[0]))
    frames = 0
    while cap.read()[0]:
        frames += 1
    cap.release()
    batches = -(-VIDEO_FRAMES // 8)
    if frames != VIDEO_FRAMES or launched != batches or k2_launched:
        raise AssertionError(f"video: {frames} frames written of "
                             f"{VIDEO_FRAMES}, K1 {launched} launches for "
                             f"{batches} batches, K2 {k2_launched} (want 0)")
    log(f"[serve] detect on a {VIDEO_FRAMES}-frame clip ({src.suffix}): "
        f"{frames} frames written to {outs[0].name}, K1 {launched} launches, "
        f"K2 {k2_launched}, {seconds:.1f}s")
    report["video"] = dict(frames=frames, k1_launches=launched,
                           k2_launches=k2_launched, seconds=seconds,
                           codec=src.suffix)


def phase_serve(cfg_cls, build_model, detect_mod, nms_cuda, csp_cuda, plain,
                smi, report):
    """The serving path (this slice's main path): K2 at 416 against its
    plain version; the ServingRuntime (buckets 608 and 416 at batch 16
    sharing one full-width bf16 PALLAS_CSP model) over HTTP, every
    response against the direct predictor, K1/K2 counted; the 608 bucket
    exported, reloaded bit-identical, and served from the artifact; a
    video through detect. Returns {run: (K1, K2)} launches."""
    from yolov4_tpu_torch.serve import ServingRuntime
    from yolov4_tpu_torch.utils.export import export_serving, load_serving

    t_phase = time.time()
    phase_k2_416(csp_cuda, plain, report)
    work = ROOT / "runs" / "chip_smoke_serve"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    kernels = (nms_cuda, csp_cuda)
    cfg = cfg_cls.from_dict({"MODEL": {"PALLAS_CSP": True}})
    sd = redraw_bn(build_model(cfg, device="cpu").state_dict(),
                   np.random.default_rng(3))
    runtime = ServingRuntime(cfg, state_dict=sd, sizes=list(SERVE_SIZES),
                             batch_size=16, conf_thre=0.25, device="cuda")
    preds = {s: b.predictor for s, b in runtime.buckets.items()}
    if preds[608].model is not preds[416].model:
        raise AssertionError("the buckets do not share one model")
    t0 = time.time()
    runtime.start(warmup=True)
    warm_s = time.time() - t0
    logs = {s: BatchLog(p) for s, p in preds.items()}
    launches = {}
    try:
        reqs = serve_requests(SERVE_REQUESTS, seed=21)
        bodies, live, k1, k2, conv = run_traffic(runtime, reqs, kernels,
                                                 "live runtime")
        batches = live["batches"]
        if k1 != batches or k2 != 3 * batches or conv != 14 * batches:
            raise AssertionError(f"live: K1 {k1}, K2 {k2}, conv {conv} "
                                 f"launches for {batches} batches (want "
                                 f"1, 3 and 14 per batch)")
        launches["live"] = (k1, k2)
        for size, log_ in logs.items():     # the direct predictor again
            preds[size].dispatch = log_.dispatch
        wants = [None] * len(reqs)
        for size in SERVE_SIZES:
            idx = [i for i, r in enumerate(reqs) if r[1] == size]
            for i, want in zip(idx, expected_responses(
                    runtime, preds[size], logs[size].batches,
                    [reqs[i] for i in idx])):
                wants[i] = want
        live["detections"] = check_responses(bodies, reqs, wants, "live")
        log(f"[serve] every live response equals the direct predictor's "
            f"rows on the same batches ({live['detections']} detections)")

        # export the 608 bucket, reload it, hold it bit-identical
        path = work / "m608.y4t"
        t0 = time.time()
        header = export_serving(preds[608], str(path))
        export_s = time.time() - t0
        artifact_mb = path.stat().st_size / 1e6
        t0 = time.time()
        art = load_serving(str(path))
        load_s = time.time() - t0
        imgs = np.stack([runtime.preprocess(img, 608)[0]
                         for img in serve_images(22, 16)])
        got = art.predict(imgs)
        want = preds[608].fetch_local(preds[608].dispatch(imgs))
        for g, w, name in zip(got, want, header["outputs"]):
            if not np.array_equal(g, w):
                raise AssertionError(f"artifact {name} differs from the "
                                     f"live predictor's")
        log(f"[serve] 608 bucket exported in {export_s:.1f}s "
            f"({artifact_mb:.1f} MB), loaded in {load_s:.1f}s, "
            f"bit-identical to the live predictor on a batch of 16 "
            f"({int(got[1].sum())} valid rows)")
        del art
    finally:
        runtime.close()

    art_rt = ServingRuntime.from_artifacts([str(path)])
    art_rt.start(warmup=True)
    art_log = BatchLog(art_rt.buckets[608].predictor)
    art_reqs = [r for r in serve_requests(2 * SERVE_ARTIFACT_REQUESTS,
                                          seed=23) if r[1] == 608]
    try:
        bodies, from_art, k1, k2, _ = run_traffic(art_rt, art_reqs, kernels,
                                                  "artifact runtime")
        batches = from_art["batches"]
        if k1 != batches or k2 != 3 * batches:
            raise AssertionError(f"artifact: K1 {k1}, K2 {k2} launches for "
                                 f"{batches} batches")
        launches["artifact"] = (k1, k2)
    finally:
        art_rt.close()
    # the served batches again through the live direct predictor
    from_art["detections"] = check_responses(
        bodies, art_reqs, expected_responses(art_rt, preds[608],
                                             art_log.batches, art_reqs),
        "artifact")
    log(f"[serve] every artifact response equals the live direct "
        f"predictor's rows on the same batches "
        f"({from_art['detections']} detections)")
    del runtime, preds, art_rt, art_log
    torch.cuda.empty_cache()

    phase_video(detect_mod, kernels, report, work)
    launches["video"] = (report["video"]["k1_launches"],
                         report["video"]["k2_launches"])
    shutil.rmtree(work, ignore_errors=True)
    report["serve"] = dict(live=live, artifact=from_art, warmup_s=warm_s,
                           export_s=export_s, load_s=load_s,
                           artifact_mb=artifact_mb,
                           launches=launches, card=smi,
                           seconds=time.time() - t_phase)
    log(f"[serve] {smi}: phase in {report['serve']['seconds']:.1f}s")
    return launches


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
    from yolov4_tpu_torch.ops.nms import greedy_nms_mask

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
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    serve_launches = phase_serve(Config, build_model, detect_mod, nms_cuda,
                                 csp_cuda, fused_csp_stage_plain, smi, report)
    serve_k1, serve_k2 = (sum(run[i] for run in serve_launches.values())
                          for i in (0, 1))
    train = train_api()
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

    ddp_launches = phase_ddp(Config, build_model, train, COCO_CLASS_IDS, smi,
                             report)
    ddp_k1, ddp_k2 = (sum(run[i] for run in ddp_launches.values())
                      for i in (0, 1))
    kernels = {"kernels": [{
        "name": "greedy_nms_mask",
        "route": "cuda",
        "source": "yolov4_tpu_torch/csrc/nms.cu",
        "replaces": "yolov4_tpu/ops/nms_pallas.py:140",
        # the detection path's batches, the serving phase's (live runtime,
        # artifact runtime, video), the Trainer's validations (the three
        # Trainer runs and their resumes; of them, the runs with
        # AUGMENTATION.DEVICE), and phase 12's data-parallel validations
        "launches": launches + serve_k1 + trainer_k1 + ddp_k1,
        "launches_in_serving": serve_k1,
        "launches_in_serving_by_run": {k: v[0] for k, v in
                                       serve_launches.items()},
        "launches_in_trainer": trainer_k1,
        "launches_in_device_aug_trainer": device_k1,
        "launches_in_ddp": ddp_k1,
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
        # val's batches, the serving phase's, the Trainer's validations
        # and phase 12's
        "launches": k2_launches + serve_k2 + trainer_k2 + ddp_k2,
        "launches_in_serving": serve_k2,
        "launches_in_serving_by_run": {k: v[1] for k, v in
                                       serve_launches.items()},
        "launches_in_trainer": trainer_k2,
        "launches_in_device_aug_trainer": device_k2,
        "launches_in_ddp": ddp_k2,
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
        "per_stage_416": [r for r in report["serve_k2_416"]
                          if r["dtype"] == "bfloat16"],
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
