#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (yolov4_tpu_torch) on one NVIDIA GPU.

Usage (from the root of a checkout, on a machine with a CUDA card and the
CUDA toolkit):

    python3 chip_smoke.py

Phases; any failure ends the run with a non-zero exit code and no result
line:

  1. build   — compile yolov4_tpu_torch/csrc/nms.cu, csrc/csp.cu and
               csrc/bn_act.cu with nvcc for sm_90a, one nvcc each, started
               together; print
               -Xptxas -v's report of each K1 kernel (registers, spills,
               shared memory; none may spill) and of each bf16 K2 kernel
               instance (registers, spills, notes) with its dynamic shared
               memory; the instances the 608 stages launch must not spill
               and must use more than 48 KB of dynamic shared memory; and
               of each batch_norm_act instance (none may spill).
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
               default body (cuDNN's convs, each followed by one
               batch_norm_act pass, phase 20) and cuDNN's convs alone on the
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
               3x the forward's conv FLOPs; no hand-written kernel
               launches in them); a fresh model's 30 steps on
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

 15. int8    — int8 serving (MODEL.QUANT, run after phase 13), on phase
               7's weights: (a) every distinct int8 product shape of the
               608/b16 forward (span full with the direct-u8 stem, whose
               27 taps pad to 32) on its real input: ops/int8.int8_conv
               (torch._int_mm on an im2col) bit-equal to int8_conv_plain
               on the card, timed beside _int_mm alone and cuDNN's bf16
               conv of the shape, with its bound and share of the int8
               peak; (b) the full-width forward at 608/b2 in int8 and
               int8_static (one calibration, the CPU's), spans late and
               full (full with the u8 stem), in bf16 on the card and
               float32 on the CPU: the card's int8-vs-bf16 error within
               INT8_TOL_VS_CPU of the CPU's int8-vs-float32 error; (c) int8
               products a forward equal to the int8 sites, K2 2 (late +
               PALLAS_CSP) or 0 (full), K1 1 a batch; (d) Predictor.run at
               608/b16 with PALLAS_CSP for none, int8 and int8_static,
               late and full (and full with the u8 stem), per call and
               device ms (a spin queued ahead); (e) an int8_static
               ServingRuntime (608 and 416 sharing one model, span late):
               64 requests, each bucket calibrated on its own first batch,
               every response equal to the direct predictor's rows, the
               608 bucket exported and bit-identical to the live program;
               (f) ``python -m yolov4_tpu_torch.val --quant int8`` on
               phase 8's synthetic COCO.

 17. mesh    — the mesh Predictor (parallel/mesh.py; run after phase 15)
               on phase 7's weights at 608, global batch 16, bfloat16,
               PALLAS_CSP, conf 0.25: two replicas on cuda:0 (and, with
               more than one card, one replica on every card), each on its
               own stream with the NMS span and the int8 abs-max taken
               over the mesh. K1 once and K2 3 times per replica in the
               batch; the detections equal, bit for bit, postprocess on
               the replicas' own forwards, and per image match the
               one-replica Predictor's at b16 (MESH_MATCH_*: cuDNN may
               choose other algorithms at b8); K2 on every stage input
               and K1 on every candidate set that the replicas' b8 shards
               give them against their plain versions (K2_TOL_*, keep
               masks equal; ``kernel_inputs``); one replica and the mesh
               timed in turns per batch (dispatch of a host batch; per
               call and device ms); what one replica_max costs (host and
               device us a call, 500 calls against none, the replicas'
               values differing at every other call and the maxima
               checked). MODEL.QUANT int8 span full on the two replicas:
               its int8 error against the one-replica bf16 forward within
               phase 15's INT8_TOL_VS_CPU of one replica's. Shards whose
               own maxima differ: far and near boxes through a lookup
               model (the mesh's rows bit-equal to one replica's on the
               whole batch, where the near shard alone gives others), and
               bright and dark images in float32 int8 span full (the dark
               rows' error against one replica within MESH_AMAX_SHARE* of
               the same mesh's with per-shard maxima). A
               ServingRuntime(mesh=...) with buckets 608 and 416 sharing
               the replicas' weights: K2 and K1 on the 416 bucket's shard
               inputs against their plain versions, then 96 requests over
               HTTP from 48 clients: every response equal to the direct
               mesh predictor's rows on the same batches, K1 and K2 per
               replica per batch, requests/s.

 18. ranks   — Predictor(group=...) over torchrun-style ranks (run after
               phase 17): two spawned gloo ranks sharing the card (NCCL
               refuses two ranks on one card), each a full-width
               Predictor at 608, b8 a rank, bf16, PALLAS_CSP, conf 0.25,
               on phase 7's weights and its rows of phase 17's batch: K1
               once and K2 3 times a rank, the rows side by side bit-equal
               to phase 17's two-replica mesh. Shards whose own maxima
               differ: the span case (lookup model; bit-equal to one
               predictor on the whole batch, the near rank alone differs)
               and the bright/dark batch in float32 int8 span full (the
               decoded forward and the detections bit-equal to the
               two-replica mesh's; the dark rank alone differs and equals
               the mesh with per-shard maxima). int8_static calibrated
               over the ranks: the mesh's scales bit for bit. A two-rank
               Trainer.evaluate on phase 12's synthetic val2017: the
               Trainer's predictor over the world group, the same AP on
               both ranks, K1 2 and K2 6 a rank. NCCL at world size 1:
               the group predictor bit-equal to the plain one at 608/b16.
               One group max timed on gloo and on NCCL (host and device
               us a call). Then the analysis tools at 608/b16 bf16:
               tools.attr_trace on Predictor.run, default and PALLAS_CSP
               (under 1 % of the device time unattributed, the scope
               groups adding up to the traced total),
               tools.check_csp_fused on phase 7's weights (parity within
               K2_TOL_BF16, the paired plain / fused ratio) and
               tools.act_bound, default and PALLAS_CSP (Mish's ceiling).

 14. classify — the classifier pretrainer (classify/, darknet_pretrain,
               run after phase 12): (a) two Adam steps of the WIDTH 0.25
               CSPDarknet53 classifier (4 classes, 64x64, batch 4) in
               float64 on the card against the CPU (TRAIN_F64_TOL_*,
               agreed_cpu_run); (b) the same with every BN a SyncBatchNorm2d
               in two ranks on the one card over gloo against the same two
               ranks on the CPU: the ranks equal bit for bit, the running
               statistics not a per-replica run's; (c) the full-width step
               (1000 classes, crop 256, batch 128, halved while it does not
               fit; bf16 autocast, f32 weights, Adam): 3 warm steps, 20
               timed with CUDA events (ms, img/s, peak memory, share of the
               bf16 peak); (d) ``python -m yolov4_tpu_torch.darknet_pretrain``
               at full width on a synthetic ImageFolder (4 classes, 32 train
               and 8 val JPEGs each, -b 16, 2 epochs; beside (b)): finite,
               falling loss, metrics.jsonl and both checkpoints, ``-e
               --resume model_best.pth`` reproducing the best epoch's
               Prec@1; K1 and K2 0 launches on all of it (in this process,
               each rank and each CLI process); then model_best.pth as
               MODEL.BACKBONE_PRETRAINED of the full-width detector (its
               backbone equal) and one 608/b2 Predictor batch.

 19. resume  — a JAX package checkpoint resumed on the card (run after
               phase 14): run A, ``Trainer`` at full width, 608/b8, bf16,
               Adam, ACCUMULATION_STEPS 2, EMA_DECAY 0.99, writes a
               mid-epoch checkpoint at batch 3 (CHECKPOINT_EVERY_STEPS 3,
               inside an accumulation window), turned by write_jax_ckpt
               into the JAX package's .ckpt (JAX tree paths, HWIO kernels,
               optax's opt_state, raw_params, meta); run B resumes the
               .ckpt and run C the port's .pth, each through ``python -m
               yolov4_tpu_torch.train --resume ... --deterministic`` (cuDNN's
               deterministic kernels) with PALLAS_CSP validation: B's
               loaded parameters, buffers, EMA, optimizer tensors, step,
               epoch and batch index bit-equal to C's, then the losses of
               the rest of the epoch and the final state bit-equal; K1 1 and
               K2 3 in each validation (a batch); the .ckpt's MB, its
               write and load seconds. The same for ``ClassifierTrainer``
               (full width, crop 256, b8, bf16, Adam) through
               ``darknet_pretrain --resume``.

 16. learning — the learning smokes at full width, 320x320, batch 8,
               bfloat16 (run after phase 14): (a) tools.overfit_smoke.run
               at its defaults, 300 steps on one batch (train-set AP50 >
               0.9); (b) tools.generalization_smoke.run's manual loop at its
               defaults, 128 training shapes, 40 epochs (fewer when its
               training, at the rate of an epoch timed before it, would
               carry phase 16 past LEARN_BUDGET_S), scored on 32 held-out shapes (AP50 >= 0.5) and on its train
               split; (c) quant_ab on (b)'s raw weights (each int8 preset's
               |dAP50| <= 0.05, approx_topk's delta exactly 0); (d) the
               held-out split with PALLAS_CSP on against off (|dAP50| <=
               0.02, K2 3 a forward), and on one held-out batch K2 on each
               stage's input and K1 on its candidates against their plain
               versions (float32 and bfloat16; the keep masks equal); (e) --use-trainer --recipe for 6
               epochs on 32 / 8 shapes (the AP curve, 6 eval records), then
               both --resume refusals (non-zero exit, the root and its
               checkpoint kept); (f) tools.export_torch on (b)'s weights,
               the .pth.tar reloaded into a fresh Predictor with
               detections bit-equal to the live weights', the COCO gate
               without data (exit 2, BLOCKED) and on (b)'s root with that
               .pth.tar (its AP = val.main's with the same arguments); (g)
               COCOeval on this host with the C matcher: the 5000-image
               val2017-scale set under 60 s, and at 500 images stats equal
               to the numpy matcher's. K1 and K2 counted over (a)-(f).

 20. bn_act  — the eval BN and activation kernel (csrc/bn_act.cu; run
               after phase 7): the 608/b64 bfloat16 Predictor with
               PALLAS_CSP on and off, BN re-drawn, launches counted over
               one batch each (K1 1, K2 3 or 0, batch_norm_act 73 or 107,
               BN_ACT_LAUNCHES); on that batch's conv outputs at the stem,
               stage 5's base conv and a neck leaky site (BN_ACT_SITES):
               the kernel against its plain version (ops/bn_act.py;
               bfloat16 within one ulp of its float32 result, contiguous
               NCHW bit-equal to channels-last, float32 within
               BN_ACT_TOL_F32), timed as in phase 3 beside the plain
               version and the eval chain it replaces, with its bound (a
               bfloat16 read and write an element); the host's enqueue a
               call, of ConvBNAct's call, the op and the chain.

Then it prints the card's name and power limit (nvidia-smi), one JSON line
``{"kernels": [...], "library_products": [...]}`` (K1, K2 and
batch_norm_act, then the int8 product, a library call) and, last, ``{"ok": true, "device":
{...}}``.
"""

from __future__ import annotations

import json
import math
import shutil
import struct
import subprocess
import sys
import threading
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
# The eval BN and activation kernel (batch_norm_act) against its plain
# version on the same conv output: bfloat16 within one bfloat16 ulp of the
# plain version's float32 result; float32 within BN_ACT_TOL_F32 of the size
# of each element's terms, |result| + |x scale| + |bias| + |mean scale|
# (where BN's shift cancels its terms to near zero, the two orders of the
# products differ by a few ulps of the terms, not of the result).
BN_ACT_TOL_F32 = 1e-6
# its sites in a 608/b64 bfloat16 forward: the stem, stage 5's base conv
# (1024 channels at 19x19) and a neck leaky site (256 at 76x76); its
# launches a batch with PALLAS_CSP (K2 takes stages 1-3's bodies) and
# without; the small shape its host enqueue is timed at
BN_ACT_BATCH = 64
BN_ACT_SITES = (("backbone.stem", "mish"), ("backbone.stage5.base", "mish"),
                ("neck.fpn.module3.1", "leaky_relu"))
BN_ACT_LAUNCHES = {"pallas_csp": 73, "default": 107}
BN_ACT_ENQUEUE_SHAPE = (2, 64, 16, 16)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3,
            queue_ahead: bool = False, spin_cycles: int = 4_000_000) -> float:
    """Median time of one call of ``fn``, from CUDA events. Between the
    events the card also idles while the host enqueues the call; with
    ``queue_ahead`` a spin kernel of ``spin_cycles`` (~2 ms by default)
    runs first, so that the call is enqueued before the card reaches it
    and the events time its kernels alone (device time)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if queue_ahead:
            torch.cuda._sleep(spin_cycles)
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


def bn_act_build_report(bn_act_cuda, report):
    """-Xptxas -v's figures for each batch_norm_act instance; none may
    spill."""
    rows = bn_act_cuda.kernel_report()
    for r in rows:
        log(f"[build] batch_norm_act {r['name']}: ptxas {r['registers']} "
            f"registers, {r['stack']} B stack, {r['spill_stores']} / "
            f"{r['spill_loads']} B spill stores / loads")
        if r["spill_stores"] or r["spill_loads"]:
            raise AssertionError(f"batch_norm_act instance spills: {r}")
    if not rows:
        raise AssertionError("the build log lacks batch_norm_act")
    report["bn_act_build"] = rows


def check_bn_act(bn_act_cuda, plain, y, norm, act):
    """batch_norm_act on the conv output ``y`` (bfloat16, channels-last)
    against its plain version: bfloat16 within one ulp of the plain float32
    result, contiguous NCHW bit-equal to channels-last, float32 within
    BN_ACT_TOL_F32 of each element's terms."""
    from yolov4_tpu_torch.ops.bn_act import bn_terms
    terms = (norm.weight, norm.bias, norm.running_mean, norm.running_var,
             norm.eps)
    f32 = plain(y.float(), *terms, act)
    got = bn_act_cuda.batch_norm_act_cuda(y, norm, act)
    nchw = bn_act_cuda.batch_norm_act_cuda(y.contiguous(), norm, act)
    if got.stride() != y.stride() or not torch.equal(got, nchw):
        raise AssertionError(f"batch_norm_act {act} {tuple(y.shape)}: "
                             "channels-last and NCHW outputs differ")
    del nchw
    _, e = torch.frexp(f32.abs().clamp_min(torch.finfo(torch.bfloat16).tiny))
    err = (got.float() - f32).abs()
    max_ulps = float((err / torch.ldexp(torch.ones_like(f32), e - 8)).max())
    del e, err
    equal_share = float((got == plain(y, *terms, act)).float().mean())
    del got
    scale, _ = bn_terms(*terms)
    y32 = y.float()
    size = ((y32 * scale[:, None, None]).abs()
            + (norm.bias.abs() + (norm.running_mean * scale).abs()
               )[:, None, None] + f32.abs())
    got32 = bn_act_cuda.batch_norm_act_cuda(y32, norm, act)
    max_rel_f32 = float(((got32 - f32).abs() / size).max())
    del f32, size, got32, y32
    res = dict(max_ulps_bf16=max_ulps, bf16_equal_share=equal_share,
               max_rel_err_f32=max_rel_f32)
    if max_ulps > 1 or max_rel_f32 > BN_ACT_TOL_F32:
        raise AssertionError(f"batch_norm_act {act} {tuple(y.shape)}: "
                             f"{res}")
    return res


def bn_act_enqueue_us(bn_act_cuda, calls=400):
    """The host's enqueue, microseconds a call at a small shape (the card
    keeps up): ConvBNAct's call, the op (an exported program's) and the
    eval chain it replaces, for each activation; median of 3 runs."""
    from yolov4_tpu_torch.models.layers import ACTIVATIONS, BatchNorm2d
    norm = BatchNorm2d(BN_ACT_ENQUEUE_SHAPE[1]).cuda().eval()
    x = torch.randn(BN_ACT_ENQUEUE_SHAPE, device="cuda").to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    terms = (norm.weight, norm.bias, norm.running_mean, norm.running_var,
             norm.eps)
    fns = {}
    for act in ("mish", "leaky_relu"):
        fns[f"{act}_call"] = (lambda a: lambda: bn_act_cuda.
                              batch_norm_act_cuda(x, norm, a))(act)
        fns[f"{act}_op"] = (lambda a: lambda: bn_act_cuda.batch_norm_act_op(
            x, *terms, a))(act)
        fns[f"{act}_chain"] = (lambda f: lambda: f(norm(x)))(
            ACTIVATIONS[act])

    def run(fn, n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        us = (time.perf_counter() - t0) / n * 1e6
        torch.cuda.synchronize()
        return us

    with torch.inference_mode():
        for fn in fns.values():
            run(fn, 50)
        return {k: float(np.median([run(fn, calls) for _ in range(3)]))
                for k, fn in fns.items()}


def phase_bn_act(cfg_cls, build_model, Predictor, bn_act_cuda, plain,
                 report):
    """The eval BN and activation kernel on the main path: the 608/b64
    bfloat16 Predictor with PALLAS_CSP on and off, BN re-drawn, its
    launches counted over one batch each; on the conv outputs of
    BN_ACT_SITES in that batch, the kernel against its plain version and
    timed beside it, the eval chain it replaces and its bound; the host's
    enqueue a call. Returns the per-site rows."""
    from yolov4_tpu_torch.models.layers import FUSED_ACTIVATIONS
    from yolov4_tpu_torch.ops import kernel_launches, launches_since
    t0 = time.time()
    cfg = cfg_cls.from_dict({"MODEL": {"PALLAS_CSP": True}})
    size, batch = cfg["TEST"]["IMGSIZE"], BN_ACT_BATCH
    rng = np.random.default_rng(5)
    sd = redraw_bn(build_model(cfg, device="cuda",
                               generator=torch.Generator().manual_seed(5))
                   .state_dict(), rng)
    for key, val in sd.items():
        if key.endswith("norm.bias"):
            sd[key] = torch.from_numpy(rng.normal(0, 0.5, val.shape)
                                       .astype(np.float32))
    pred = Predictor(cfg, state_dict=sd, img_size=size, batch_size=batch,
                     device="cuda")
    del sd
    pred.warmup()
    x = pred.upload(rng.integers(0, 256, (batch, size, size, 3),
                                 dtype=np.uint8))
    convs = {}

    def keep(name):
        return lambda mod, inp, out: convs.__setitem__(name, out.clone())

    hooks = [pred.model.get_submodule(name).conv.register_forward_hook(
        keep(name)) for name, _ in BN_ACT_SITES]
    torch.cuda.synchronize()
    before = kernel_launches()
    pred.run(x)
    torch.cuda.synchronize()
    launches = {"pallas_csp": launches_since(before)}
    for h in hooks:
        h.remove()
    bb = pred.model.backbone
    for stage in (bb.stage1, bb.stage2, bb.stage3):
        stage.fused = False
    pred.run(x)
    torch.cuda.synchronize()
    before = kernel_launches()
    pred.run(x)
    torch.cuda.synchronize()
    launches["default"] = launches_since(before)
    want = {key: {"greedy_nms_mask": 1, "fused_csp_stage": 3 * (key ==
                                                               "pallas_csp"),
                  "batch_norm_act": n} for key, n in BN_ACT_LAUNCHES.items()}
    if launches != want:
        raise AssertionError(f"kernel launches in a 608/b{batch} batch: "
                             f"{launches}, expected {want}")
    log(f"[bn_act] 608/b{batch} bf16 Predictor batch, kernel launches with "
        f"PALLAS_CSP {launches['pallas_csp']}, without {launches['default']}")

    sites = []
    with torch.inference_mode():
        for name, act in BN_ACT_SITES:
            site = pred.model.get_submodule(name)
            if FUSED_ACTIVATIONS.get(site.act) != act:
                raise AssertionError(f"{name} runs {site.act}, not {act}")
            y, norm = convs.pop(name), site.norm
            res = check_bn_act(bn_act_cuda, plain, y, norm, act)
            ms = cuda_ms(lambda: bn_act_cuda.batch_norm_act_cuda(y, norm,
                                                                 act))
            device_ms = cuda_ms(lambda: bn_act_cuda.batch_norm_act_cuda(
                y, norm, act), queue_ahead=True)
            terms = (norm.weight, norm.bias, norm.running_mean,
                     norm.running_var, norm.eps)
            plain_ms = cuda_ms(lambda: plain(y, *terms, act), iters=5)
            chain_ms = cuda_ms(lambda: site.act(norm(y)), iters=5)
            # a bfloat16 read and a bfloat16 write an element
            bound_ms = 4.0 * y.numel() / PEAK_BYTES * 1e3
            sites.append(dict(
                site=name, act=act, shape=list(y.shape),
                y_std=float(y.float().std()), ms=ms, device_ms=device_ms,
                plain_ms=plain_ms, chain_ms=chain_ms, bound_ms=bound_ms,
                bound_by="bytes", roofline_pct=100.0 * bound_ms / device_ms,
                **res))
            log(f"[bn_act] {name} {act} {tuple(y.shape)}: {ms:.4f} ms "
                f"(device {device_ms:.4f} ms, {sites[-1]['roofline_pct']:.1f}"
                f" % of its {bound_ms:.4f} ms bound), plain {plain_ms:.4f} "
                f"ms, eval chain {chain_ms:.4f} ms; {res}")
            del y
            torch.cuda.empty_cache()
    del pred, x, convs
    torch.cuda.empty_cache()
    enqueue = bn_act_enqueue_us(bn_act_cuda)
    log(f"[bn_act] host enqueue, us a call at {BN_ACT_ENQUEUE_SHAPE}: "
        f"{enqueue}")
    report["bn_act"] = dict(launches=launches, sites=sites,
                            enqueue_us=enqueue, seconds=time.time() - t0)
    return sites


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
    from yolov4_tpu_torch.ops import kernel_launches, launches_since
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
    before = kernel_launches()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        state = step(state, images, labels)
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / n
    # a train step runs with autograd in training mode: none of the
    # hand-written kernels
    launches = launches_since(before)
    if any(launches.values()):
        raise AssertionError(f"kernel launches in {n} train steps: "
                             f"{launches}")
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
        train_tflop=flops / 1e12, flop_share_bf16=share, losses=losses,
        kernel_launches_per_step={k: v // n for k, v in launches.items()})


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
    # the eval BN and activation pass: every ConvBNAct with BN outside K2's
    # stage bodies, 73 a PALLAS_CSP forward
    want = {"greedy_nms_mask": n_val, "fused_csp_stage": 3 * n_val,
            "batch_norm_act": 73 * n_val}
    if (not (out / "checkpoint.pth").exists() or len(evals) != 1
            or evals[0]["launches"] != want):
        raise AssertionError(f"torchrun train wrote {sorted(os.listdir(out))}"
                             f", eval records {evals} (kernel launches "
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


# --------------------------------------------------------------------------
# Phase 15: int8 serving (MODEL.QUANT int8 / int8_static, ops/int8.py)

PEAK_INT8_OPS = 1979e12   # dense int8 tensor cores, H100 SXM data sheet
# (b) The card's int8 forward in bfloat16 against its bfloat16 forward may
# be this much further apart than the CPU's int8 forward in float32 from
# its float32 forward (raw head maps, mean and max |difference|): the card
# rounds every dequantized activation to bfloat16 (2^-9 relative) on top
# of int8's per-tensor step (1/254 of the abs-max), and its conv weights
# are bfloat16 before the fold. The max also gets one bfloat16 ulp of the
# largest output: each of the two card forwards stores its head maps in
# bfloat16, half an ulp each.
INT8_TOL_VS_CPU = 1.5
# (b)'s cases: (QUANT, QUANT_SPAN, QUANT_STEM); the stem case takes uint8
INT8_CASES = (("int8", "late", False), ("int8", "full", False),
              ("int8_static", "late", False), ("int8_static", "full", True))
# (d)'s Predictor configurations, PALLAS_CSP on
INT8_RUNS = (("none", "late", False), ("int8", "late", False),
             ("int8", "full", False), ("int8_static", "late", False),
             ("int8_static", "full", False), ("int8_static", "full", True))
# a spin of ~150 ms queued ahead of a whole Predictor.run, longer than its
# enqueue, so that the events time the card alone (device ms)
RUN_SPIN_CYCLES = 300_000_000
INT8_SERVE_REQUESTS = 64


def int8_cfg(cfg_cls, quant, span="late", stem=False, dtype="bfloat16",
             pallas=False):
    return cfg_cls.from_dict({"MODEL": {
        "QUANT": quant, "QUANT_SPAN": span, "QUANT_STEM": stem,
        "COMPUTE_DTYPE": dtype, "PALLAS_CSP": pallas}})


def int8_weights(cfg_cls, build_model):
    """Phase 7's weights: the seed-0 init with BN re-drawn."""
    return redraw_bn(build_model(int8_cfg(cfg_cls, "none", dtype="float32"),
                                 device="cpu").state_dict(),
                     np.random.default_rng(3))


@contextmanager
def spy_int8(layers_mod, seen):
    """Record the first (xq, wq) of every distinct int8 product shape the
    model runs inside the block, and how often each shape runs."""
    orig = layers_mod.int8_conv

    def spy(xq, wq, stride=1, padding=0, pad_value=0):
        key = (tuple(xq.shape), tuple(wq.shape), stride, padding, pad_value)
        if key not in seen:
            seen[key] = [xq.clone(), wq.clone(), 0]
        seen[key][2] += 1
        return orig(xq, wq, stride, padding, pad_value)

    layers_mod.int8_conv = spy
    try:
        yield
    finally:
        layers_mod.int8_conv = orig


def int8_bound(xq, wq, ho, wo):
    """(ops, bound_ms, bound_by) of one product: 2 M K N int8 operations
    over the int8 peak against x and w read and the int32 output written
    once over HBM's rate."""
    b, _, _, ci = xq.shape
    co, kh, kw, _ = wq.shape
    m, k = b * ho * wo, kh * kw * ci
    ops = 2.0 * m * k * co
    nbytes = xq.numel() + wq.numel() + 4 * m * co
    t_ops, t_bytes = ops / PEAK_INT8_OPS, nbytes / PEAK_BYTES
    return ops, max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                            else "bytes")


def phase_int8_products(cfg_cls, build_model, int8_mod, layers_mod, sd,
                        report):
    """(a) every distinct int8 product shape of the 608/b16 forward (span
    full with the direct-u8 stem: every shape of either span) on its real
    input: bit-equal to the plain version on the card, timed beside
    ``_int_mm`` alone and cuDNN's bf16 conv of the same shape."""
    import torch.nn.functional as F
    model = build_model(int8_cfg(cfg_cls, "int8", "full", True),
                        device="cuda")
    model.load_state_dict(sd)
    model = model.eval().to(memory_format=torch.channels_last)
    x = torch.randint(0, 256, (16, 3, 608, 608), dtype=torch.uint8,
                      device="cuda",
                      generator=torch.Generator("cuda").manual_seed(5))
    seen = {}
    with torch.inference_mode(), spy_int8(layers_mod, seen):
        model(x.contiguous(memory_format=torch.channels_last))
    del model
    torch.cuda.empty_cache()
    rows = []
    with torch.inference_mode():
        for (xs, ws, stride, pad, pv), (xq, wq, count) in seen.items():
            got = int8_mod.int8_conv(xq, wq, stride, pad, pv)
            want = int8_mod.int8_conv_plain(xq, wq, stride, pad, pv)
            if not torch.equal(got, want):
                raise AssertionError(f"int8_conv {xs} x {ws} s{stride}: "
                                     f"{int((got != want).sum())} int32 "
                                     "sums differ from the plain version's")
            co, kh, kw, ci = ws
            kk = kh * kw * ci
            kp = -(-kk // int8_mod.ALIGN) * int8_mod.ALIGN
            a = (xq.reshape(-1, ci) if kh == 1 and stride == 1 and kp == kk
                 else int8_mod.im2col(xq, kh, kw, stride, pad, pv, width=kp))
            wt = F.pad(wq.reshape(co, kk), (0, kp - kk, 0, (-co) % 8))
            xb = xq.permute(0, 3, 1, 2).to(torch.bfloat16).contiguous(
                memory_format=torch.channels_last)
            wb = wq.permute(0, 3, 1, 2).to(torch.bfloat16).contiguous(
                memory_format=torch.channels_last)
            ho, wo = got.shape[1], got.shape[2]
            ops, bound_ms, bound_by = int8_bound(xq, wq, ho, wo)
            row = dict(
                x=list(xs), w=list(ws), stride=stride, padding=pad,
                pad_value=pv, k_padded=kp, per_forward=count,
                ms=cuda_ms(lambda: int8_mod.int8_conv(xq, wq, stride, pad,
                                                      pv), iters=10),
                device_ms=cuda_ms(lambda: int8_mod.int8_conv(
                    xq, wq, stride, pad, pv), iters=10, queue_ahead=True),
                int_mm_ms=cuda_ms(lambda: torch._int_mm(a, wt.t()),
                                  iters=10, queue_ahead=True),
                plain_ms=cuda_ms(lambda: int8_mod.int8_conv_plain(
                    xq, wq, stride, pad, pv), iters=3, warmup=1),
                cudnn_bf16_ms=cuda_ms(lambda: F.conv2d(
                    xb, wb, stride=stride, padding=pad), iters=10,
                    queue_ahead=True),
                bound_ms=bound_ms, bound_by=bound_by, tops=ops * 1e-12)
            row["peak_share"] = ops / (row["device_ms"] * 1e-3) / PEAK_INT8_OPS
            row["int_mm_peak_share"] = (ops / (row["int_mm_ms"] * 1e-3)
                                        / PEAK_INT8_OPS)
            rows.append(row)
            log(f"[int8] {xs} x {ws} s{stride} p{pad}/{pv} (K {kk}->{kp}, "
                f"{count}x a forward): bit-equal; {row['ms']:.4f} ms, device "
                f"{row['device_ms']:.4f} (_int_mm {row['int_mm_ms']:.4f}), "
                f"plain {row['plain_ms']:.3f}, cuDNN bf16 "
                f"{row['cudnn_bf16_ms']:.4f}; bound {bound_ms:.4f} ms by "
                f"{bound_by}; {100 * row['peak_share']:.2f}% of the int8 "
                f"peak (_int_mm {100 * row['int_mm_peak_share']:.2f}%)")
            del a, wt, xb, wb, got, want
    del seen
    torch.cuda.empty_cache()
    per_fwd = lambda key: sum(r[key] * r["per_forward"] for r in rows)
    out = dict(shapes=rows, sites=sum(r["per_forward"] for r in rows),
               **{f"forward_{k}": per_fwd(k) for k in (
                   "ms", "device_ms", "int_mm_ms", "plain_ms",
                   "cudnn_bf16_ms", "bound_ms")})
    log(f"[int8] {len(rows)} distinct shapes, {out['sites']} products a "
        f"608/b16 forward (full span, u8 stem): device "
        f"{out['forward_device_ms']:.3f} ms (_int_mm "
        f"{out['forward_int_mm_ms']:.3f}), cuDNN bf16 "
        f"{out['forward_cudnn_bf16_ms']:.3f}, bound "
        f"{out['forward_bound_ms']:.4f} ms")
    report["int8_products"] = out
    return out


def phase_int8_vs_cpu(cfg_cls, build_model, int8_mod, sd, report):
    """(b) the full-width forward at 608/b2 in both modes and spans on the
    card in bf16 against the CPU in float32, int8_static on one
    calibration (the CPU's); (c) the card's int8 products per forward
    equal to the int8 site count."""
    from yolov4_tpu_torch.models.layers import (quant_entries, quant_scope,
                                                quant_sites)
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.integers(0, 256, (2, 3, 608, 608),
                                      dtype=np.uint8))
    cal = torch.from_numpy(rng.integers(0, 256, (2, 3, 608, 608),
                                        dtype=np.uint8))

    def model_for(quant, span, stem, device):
        m = build_model(int8_cfg(cfg_cls, quant, span, stem,
                                 "bfloat16" if device == "cuda"
                                 else "float32"), device=device)
        m.load_state_dict(sd)
        m.eval()
        return (m.to(memory_format=torch.channels_last) if device == "cuda"
                else m)

    def maps(m, inp, state=None):
        with torch.inference_mode(), quant_scope(state):
            out = m(inp.to(next(m.parameters()).device).contiguous(
                memory_format=torch.channels_last), decode=False)
            return torch.cat([o.float().flatten() for o in out]).cpu()

    base = {dev: maps(model_for("none", "late", False, dev), x)
            for dev in ("cpu", "cuda")}
    rows = []
    for quant, span, stem in INT8_CASES:
        t0 = time.time()
        cpu_m, gpu_m = (model_for(quant, span, stem, d)
                        for d in ("cpu", "cuda"))
        raw = cpu_state = gpu_state = None
        if quant == "int8_static":
            raw = {}
            with torch.inference_mode(), quant_scope(raw, recording=True):
                cpu_m(cal, decode=False)
            cpu_state = quant_entries(cpu_m, raw)
            gpu_state = quant_entries(gpu_m, raw)
        want = maps(cpu_m, x, cpu_state)
        int8_mod.int8_conv.launches = 0
        got = maps(gpu_m, x, gpu_state)
        launches = int8_mod.int8_conv.launches
        sites = len(quant_sites(gpu_m))
        if launches != sites:
            raise AssertionError(f"{quant}/{span}: {launches} int8 products "
                                 f"in a forward of {sites} int8 sites")
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{quant}/{span}: non-finite card output")
        e_gpu, e_cpu = (got - base["cuda"]).abs(), (want - base["cpu"]).abs()
        row = dict(quant=quant, span=span, stem=stem, sites=sites,
                   launches=launches,
                   card_vs_bf16_mean=float(e_gpu.mean()),
                   card_vs_bf16_max=float(e_gpu.max()),
                   cpu_vs_f32_mean=float(e_cpu.mean()),
                   cpu_vs_f32_max=float(e_cpu.max()),
                   card_vs_cpu_mean=float((got - want).abs().mean()),
                   seconds=time.time() - t0)
        rows.append(row)
        log(f"[int8] 608/b2 {quant} {span}{' +u8 stem' if stem else ''}: "
            f"{sites} sites, {launches} products; int8 vs bf16 on the card "
            f"mean {row['card_vs_bf16_mean']:.4g} max "
            f"{row['card_vs_bf16_max']:.4g}, int8 vs f32 on the CPU mean "
            f"{row['cpu_vs_f32_mean']:.4g} max {row['cpu_vs_f32_max']:.4g} "
            f"({row['seconds']:.1f}s)")
        row["bf16_ulp"] = 2.0 ** (math.floor(math.log2(
            float(base["cuda"].abs().max()))) - 7)
        for k, extra in (("mean", 0.0), ("max", row["bf16_ulp"])):
            if row[f"card_vs_bf16_{k}"] > (INT8_TOL_VS_CPU
                                           * row[f"cpu_vs_f32_{k}"] + extra):
                raise AssertionError(
                    f"{quant}/{span}: the card's int8 error ({k}) "
                    f"{row[f'card_vs_bf16_{k}']:.4g} exceeds "
                    f"{INT8_TOL_VS_CPU}x the CPU's "
                    f"{row[f'cpu_vs_f32_{k}']:.4g} (+ {extra:.4g})")
        del cpu_m, gpu_m, cpu_state, gpu_state, raw
        torch.cuda.empty_cache()
    report["int8_vs_cpu"] = rows
    return rows


def phase_int8_runs(cfg_cls, Predictor, int8_mod, nms_cuda, csp_cuda, sd,
                    report):
    """(c) launches per forward and (d) Predictor.run at 608/b16 with
    PALLAS_CSP on: K1 once, K2 twice (span late: stages 1-2 fused, stage 3
    int8) or never (span full), int8 products equal to the sites."""
    from yolov4_tpu_torch.models.layers import quant_sites
    rng = np.random.default_rng(9)
    images = [rng.integers(0, 256, (16, 608, 608, 3), dtype=np.uint8)
              for _ in range(2)]
    rows = []
    for quant, span, stem in INT8_RUNS:
        pred = Predictor(int8_cfg(cfg_cls, quant, span, stem, pallas=True),
                         state_dict=sd, img_size=608, batch_size=16,
                         device="cuda")
        pred.warmup()
        dets, valid = pred(images[0])      # int8_static calibrates on it
        if not (np.isfinite(dets).all() and valid.any()):
            raise AssertionError(f"{quant}/{span}: detections not finite "
                                 "or none")
        x = pred.upload(images[1])
        torch.cuda.synchronize()
        nms_cuda.greedy_nms_mask_cuda.launches = 0
        csp_cuda.fused_csp_stage_cuda.launches = 0
        int8_mod.int8_conv.launches = 0
        pred.run(x)
        torch.cuda.synchronize()
        k1 = nms_cuda.greedy_nms_mask_cuda.launches
        k2 = csp_cuda.fused_csp_stage_cuda.launches
        n8 = int8_mod.int8_conv.launches
        sites = len(quant_sites(pred.model))
        want_k2 = 3 if quant == "none" else (2 if span == "late" else 0)
        if (k1, k2, n8) != (1, want_k2, sites):
            raise AssertionError(f"{quant}/{span}: K1 {k1}, K2 {k2}, int8 "
                                 f"{n8} launches a batch (want 1, "
                                 f"{want_k2}, {sites})")
        t0 = time.perf_counter()
        pred.run(x)
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        run_ms = cuda_ms(lambda: pred.run(x), iters=10)
        device_ms = cuda_ms(lambda: pred.run(x), iters=10, queue_ahead=True,
                            spin_cycles=RUN_SPIN_CYCLES)
        rows.append(dict(quant=quant, span=span, stem=stem, sites=sites,
                         k1=k1, k2=k2, int8=n8, run_ms=run_ms,
                         device_ms=device_ms, enqueue_ms=enqueue_ms,
                         device_img_s=16e3 / device_ms))
        log(f"[int8] Predictor 608/b16 PALLAS_CSP {quant} {span}"
            f"{' +u8 stem' if stem else ''}: K1 {k1}, K2 {k2}, int8 {n8} "
            f"a batch; run {run_ms:.3f} ms, device {device_ms:.3f} ms "
            f"({16e3 / device_ms:.1f} img/s), host enqueue "
            f"{enqueue_ms:.1f} ms")
        del pred, x
        torch.cuda.empty_cache()
    report["int8_runs"] = rows
    return rows


def phase_int8_serve(cfg_cls, Predictor, int8_mod, nms_cuda, csp_cuda, sd,
                     report):
    """(e) int8_static serving: buckets 608 and 416 sharing one model, each
    calibrating on its own first batch; every response against the direct
    predictor; the 608 bucket exported and held bit-identical."""
    from yolov4_tpu_torch.models.layers import quant_sites
    from yolov4_tpu_torch.serve import ServingRuntime
    from yolov4_tpu_torch.utils.export import export_serving, load_serving
    work = ROOT / "runs" / "chip_smoke_int8"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    cfg = int8_cfg(cfg_cls, "int8_static", "late", pallas=True)
    runtime = ServingRuntime(cfg, state_dict=sd, sizes=list(SERVE_SIZES),
                             batch_size=16, conf_thre=0.25, device="cuda")
    preds = {s: b.predictor for s, b in runtime.buckets.items()}
    sites = len(quant_sites(preds[608].model))
    runtime.start(warmup=True)
    if any(p.quant_ready for p in preds.values()):
        raise AssertionError("a bucket counts warmup's seed scales as "
                             "calibrated")
    logs = {s: BatchLog(p) for s, p in preds.items()}
    try:
        reqs = serve_requests(INT8_SERVE_REQUESTS, seed=31)
        int8_mod.int8_conv.launches = 0
        bodies, m, k1, k2, conv = run_traffic(
            runtime, reqs, (nms_cuda, csp_cuda), "int8_static runtime")
        n8 = int8_mod.int8_conv.launches
        batches = m["batches"]
        # each bucket's first batch also runs its calibration pass (the
        # forward without the NMS)
        forwards = batches + len(preds)
        if (k1, k2, n8) != (batches, 2 * forwards, sites * forwards):
            raise AssertionError(f"int8 serving: K1 {k1}, K2 {k2}, int8 {n8} "
                                 f"launches for {batches} batches")
        for size, log_ in logs.items():
            preds[size].dispatch = log_.dispatch
            ref = Predictor(cfg, img_size=size, batch_size=16, device="cuda",
                            model=preds[size].model)
            ref.calibrate(log_.batches[0])
            got, want = preds[size].quant_state, ref.quant_state
            if not all(torch.allclose(got[k]["amax"], want[k]["amax"],
                                      rtol=1e-6, atol=0) for k in want):
                raise AssertionError(f"bucket {size}: scales are not its own "
                                     "first batch's")
        a, b = preds[608].quant_state, preds[416].quant_state
        if all(torch.equal(a[k]["amax"], b[k]["amax"]) for k in a):
            raise AssertionError("the two buckets share their scales")
        wants = [None] * len(reqs)
        for size in SERVE_SIZES:
            idx = [i for i, r in enumerate(reqs) if r[1] == size]
            for i, want in zip(idx, expected_responses(
                    runtime, preds[size], logs[size].batches,
                    [reqs[i] for i in idx])):
                wants[i] = want
        m["detections"] = check_responses(bodies, reqs, wants, "int8")
        log(f"[int8] each bucket calibrated on its own first batch; every "
            f"response equals the direct predictor's rows "
            f"({m['detections']} detections)")
        path = work / "m608_int8.y4t"
        t0 = time.time()
        header = export_serving(preds[608], str(path))
        export_s = time.time() - t0
        art = load_serving(str(path))
        imgs = np.stack([runtime.preprocess(img, 608)[0]
                         for img in serve_images(32, 16)])
        got = art.predict(imgs)
        want = preds[608].fetch_local(preds[608].dispatch(imgs))
        for g, w, name in zip(got, want, header["outputs"]):
            if not np.array_equal(g, w):
                raise AssertionError(f"int8_static artifact {name} differs "
                                     "from the live predictor's")
        mb = path.stat().st_size / 1e6
        log(f"[int8] 608 int8_static bucket exported in {export_s:.1f}s "
            f"({mb:.1f} MB, quant {header['quant']}), bit-identical to the "
            f"live predictor ({int(got[1].sum())} valid rows)")
        del art
    finally:
        runtime.close()
        shutil.rmtree(work, ignore_errors=True)
    report["int8_serve"] = dict(m, k1=k1, k2=k2, int8=n8, sites=sites,
                                export_s=export_s, artifact_mb=mb)
    del runtime, preds
    torch.cuda.empty_cache()
    return k1, k2


def phase_int8_val(val_mod, coco_ids, int8_mod, nms_cuda, csp_cuda, sites,
                   report):
    """(f) ``python -m yolov4_tpu_torch.val --quant int8`` on phase 8's
    synthetic COCO, span late (``sites`` int8 sites) with PALLAS_CSP."""
    work = ROOT / "runs" / "chip_smoke_int8_val"
    shutil.rmtree(work, ignore_errors=True)
    n_images, batch = 32, 16
    write_val2017(work, coco_ids, n_images)
    cfg_path = work / "val.cfg"
    cfg_path.write_text("MODEL:\n  PALLAS_CSP: true\n  QUANT_SPAN: late\n")
    nms_cuda.greedy_nms_mask_cuda.launches = 0
    csp_cuda.fused_csp_stage_cuda.launches = 0
    int8_mod.int8_conv.launches = 0
    t0 = time.time()
    ap, ap50 = val_mod.main([str(work), "-c", str(cfg_path), "--batch-size",
                             str(batch), "--conf-thre", "0.001", "--quant",
                             "int8"])
    seconds = time.time() - t0
    k1 = nms_cuda.greedy_nms_mask_cuda.launches
    k2 = csp_cuda.fused_csp_stage_cuda.launches
    n8 = int8_mod.int8_conv.launches
    n_batches = n_images // batch
    shutil.rmtree(work, ignore_errors=True)
    if not (np.isfinite(ap) and np.isfinite(ap50) and 0.0 <= ap <= ap50 <= 1.0):
        raise AssertionError(f"int8 val: AP {ap}, AP50 {ap50}")
    if (k1, k2, n8) != (n_batches, 2 * n_batches, sites * n_batches):
        raise AssertionError(f"int8 val: K1 {k1}, K2 {k2}, int8 {n8} "
                             f"launches in {n_batches} batches")
    log(f"[int8] val --quant int8 on {n_images} images: AP {ap:.5f}, AP50 "
        f"{ap50:.5f}; K1 {k1}, K2 {k2}, int8 {n8} launches in {n_batches} "
        f"batches; {seconds:.1f}s")
    report["int8_val"] = dict(ap=ap, ap50=ap50, k1=k1, k2=k2, int8=n8,
                              seconds=seconds)
    return k1, k2


def phase_int8(cfg_cls, build_model, Predictor, val_mod, coco_ids,
               nms_cuda, csp_cuda, smi, report):
    """Phase 15; returns (K1, K2, int8) launches of its runs."""
    from yolov4_tpu_torch.models import layers as layers_mod
    from yolov4_tpu_torch.ops import int8 as int8_mod
    t_phase = time.time()
    sd = int8_weights(cfg_cls, build_model)
    products = phase_int8_products(cfg_cls, build_model, int8_mod,
                                   layers_mod, sd, report)
    phase_int8_vs_cpu(cfg_cls, build_model, int8_mod, sd, report)
    runs = phase_int8_runs(cfg_cls, Predictor, int8_mod, nms_cuda, csp_cuda,
                           sd, report)
    serve_k1, serve_k2 = phase_int8_serve(cfg_cls, Predictor, int8_mod,
                                          nms_cuda, csp_cuda, sd, report)
    sites_late = next(r["sites"] for r in runs
                      if (r["quant"], r["span"]) == ("int8", "late"))
    val_k1, val_k2 = phase_int8_val(val_mod, coco_ids, int8_mod, nms_cuda,
                                    csp_cuda, sites_late, report)
    k1 = sum(r["k1"] for r in runs) + serve_k1 + val_k1
    k2 = sum(r["k2"] for r in runs) + serve_k2 + val_k2
    n8 = (sum(r["launches"] for r in report["int8_vs_cpu"])
          + sum(r["int8"] for r in runs) + report["int8_serve"]["int8"]
          + report["int8_val"]["int8"])
    report["int8_phase"] = dict(card=smi, seconds=time.time() - t_phase,
                                k1=k1, k2=k2, int8=n8)
    log(f"[int8] {smi}: phase 15 in {report['int8_phase']['seconds']:.1f}s")
    return k1, k2, n8, products


# --------------------------------------------------------------------------
# Phase 17: the mesh Predictor (parallel/mesh.py) and serve --mesh

MESH_CONF = 0.25                 # phase 13's serving cut
MESH_SERVE_REQUESTS = 96
# The mesh's detections against the one-replica Predictor at b16. The
# replicas run every convolution at b8, where cuDNN may choose another
# algorithm than at b16, so the two bfloat16 forwards may differ in
# rounding, and a near-tie in the top-K or the NMS may then go the other
# way. Per image, every valid row of either side must find one on the
# other of the same class with IoU >= MESH_MATCH_IOU and a score within
# MESH_MATCH_SCORE, for at least MESH_MATCH_SHARE of the rows. The mesh's
# postprocess itself is held bit for bit: the same function on its
# replicas' concatenated forwards gives its detections.
MESH_MATCH_IOU = 0.9
MESH_MATCH_SCORE = 0.02
MESH_MATCH_SHARE = 0.9


def mesh_forward(pred, images):
    """The decoded predictions [B, N, 85] of a mesh predictor's replicas on
    their rows of ``images`` (padded), each replica on its own stream with
    the batch-global maxima taken across them (``ReplicaRunner``, as
    ``dispatch`` does), joined on the first device."""
    from yolov4_tpu_torch.engine.predictor import model_input, pad_batch
    from yolov4_tpu_torch.parallel.mesh import ReplicaRunner
    host = torch.from_numpy(pad_batch(images, pred.batch_size))
    shards = pred.mesh.shards(pred.batch_size)

    def replica(rank):
        device = pred.mesh.devices[rank]
        model = pred.replicas[device]
        with torch.inference_mode():
            x = host[shards[rank]].to(device).permute(0, 3, 1, 2)
            return model(model_input(model, x)).to(pred.device)

    return torch.cat(ReplicaRunner(pred.mesh).run(replica))


def one_forward(pred, images):
    """The one-replica predictor's decoded predictions on ``images``."""
    from yolov4_tpu_torch.engine.predictor import model_input
    with torch.inference_mode():
        x = pred.upload(images).permute(0, 3, 1, 2)
        return pred.model(model_input(pred.model, x))


def pred_errors(got, want):
    d = (got.float() - want.float()).abs()
    return dict(score_mean=float(d[..., 4:].mean()),
                score_max=float(d[..., 4:].max()),
                box_mean_px=float(d[..., :4].mean()),
                box_max_px=float(d[..., :4].max()))


def match_shares(a, b):
    """Per image, the smaller of the two shares of valid rows of ``a`` found
    in ``b`` and of ``b`` found in ``a`` (same class, IoU >=
    MESH_MATCH_IOU, score within MESH_MATCH_SCORE)."""

    def found(x, y):
        if len(x) == 0:
            return 1.0
        if len(y) == 0:
            return 0.0
        lt = np.maximum(x[:, None, :2], y[None, :, :2])
        rb = np.minimum(x[:, None, 2:4], y[None, :, 2:4])
        inter = np.clip(rb - lt, 0, None).prod(-1)
        area = lambda r: (r[:, 2] - r[:, 0]) * (r[:, 3] - r[:, 1])  # noqa
        iou = inter / (area(x)[:, None] + area(y)[None] - inter)
        sx, sy = x[:, 4] * x[:, 5], y[:, 4] * y[:, 5]
        ok = ((x[:, None, 6] == y[None, :, 6]) & (iou >= MESH_MATCH_IOU)
              & (np.abs(sx[:, None] - sy[None]) <= MESH_MATCH_SCORE))
        return float(ok.any(1).mean())

    (da, va), (db, vb) = a, b
    return [min(found(da[i][va[i]], db[i][vb[i]]),
                found(db[i][vb[i]], da[i][va[i]])) for i in range(len(da))]


def mesh_case(label, pred, one, images, kernels, k2_per_forward,
              int8_mod=None):
    """Drive ``pred`` (a mesh predictor) on one batch with the counts set to
    0 just before and read just after; then hold its detections bit for
    bit against postprocess on its replicas' forwards and, per image,
    against the one-replica predictor's at MESH_MATCH_*. Returns the
    report's row (the launches included), the mesh's decoded predictions,
    one replica's, and the mesh's detections."""
    from yolov4_tpu_torch.ops.postprocess import postprocess
    nms_cuda, csp_cuda = kernels
    n = pred.mesh.size
    torch.cuda.synchronize()
    nms_cuda.greedy_nms_mask_cuda.launches = 0
    csp_cuda.fused_csp_stage_cuda.launches = 0
    if int8_mod is not None:
        int8_mod.int8_conv.launches = 0
    got = pred(images)
    torch.cuda.synchronize()
    k1 = nms_cuda.greedy_nms_mask_cuda.launches
    k2 = csp_cuda.fused_csp_stage_cuda.launches
    n8 = None if int8_mod is None else int8_mod.int8_conv.launches
    if (k1, k2) != (n, k2_per_forward * n):
        raise AssertionError(f"{label}: K1 {k1}, K2 {k2} launches in one "
                             f"batch on {n} replicas (want {n}, "
                             f"{k2_per_forward * n})")
    if not (np.isfinite(got[0]).all() and got[1].any()):
        raise AssertionError(f"{label}: detections not finite or none")
    raw = mesh_forward(pred, images)
    with torch.inference_mode():
        check = postprocess(raw, **pred.settings())
    check = [t[:len(images)].cpu().numpy() for t in check[:2]]
    for g, w, name in zip(got, check, ("detections", "valid")):
        if not np.array_equal(g, w):
            raise AssertionError(f"{label}: the mesh's {name} differ from "
                                 "postprocess on its replicas' forwards")
    want = one(images)
    raw_one = one_forward(one, images)
    shares = match_shares(got, want)
    row = dict(label=label, replicas=n,
               devices=[str(d) for d in pred.mesh.devices],
               batch=pred.batch_size, k1=k1, k2=k2, int8=n8,
               valid_rows=int(got[1].sum()),
               valid_rows_one=int(want[1].sum()),
               bit_equal_to_one=all(np.array_equal(g, w)
                                    for g, w in zip(got, want)),
               forward_vs_one=pred_errors(raw[:len(images)],
                                          raw_one[:len(images)]),
               min_match_share=min(shares),
               mean_match_share=float(np.mean(shares)))
    log(f"[mesh] {label}: K1 {k1}, K2 {k2}"
        f"{'' if n8 is None else f', int8 {n8}'} launches in one batch on "
        f"{n} replicas; detections = postprocess on the replicas' "
        f"forwards, bit for bit; against one replica at b{one.batch_size}: "
        f"bit-equal {row['bit_equal_to_one']}, {row['valid_rows']} vs "
        f"{row['valid_rows_one']} valid rows, match share min "
        f"{row['min_match_share']:.4f} mean {row['mean_match_share']:.4f}; "
        f"forwards {row['forward_vs_one']}")
    return row, raw, raw_one, got


def replica_max_cost(mesh, calls=500):
    """What one ``replica_max`` costs on ``mesh``: a run of ``calls``
    maxima on every replica against the same run without them, in host
    time and in device time (CUDA events around the run, a spin kernel
    queued ahead so that the events time the card alone); per call. At
    every other call the replicas' values differ (replica r adds r), so
    the run's result holds the maxima: each replica must end at
    ``calls + (n - 1) * (calls // 2)``, where a replica that kept its own
    value or read a peer's before it was written would end elsewhere."""
    from yolov4_tpu_torch.ops.replica import replica_max
    from yolov4_tpu_torch.parallel.mesh import ReplicaRunner
    runner = ReplicaRunner(mesh)

    def timed(with_max):
        def fn(rank):
            v = torch.zeros((), device=mesh.devices[rank])
            for step in range(calls):
                v = v + (1 + rank * (step % 2))
                if with_max:
                    v = replica_max(v)
            return v

        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(RUN_SPIN_CYCLES)
        start.record()
        t0 = time.perf_counter()
        out = runner.run(fn)
        host_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        torch.cuda.synchronize()
        return host_ms, start.elapsed_time(end), out

    timed(True)
    host1, dev1, out = timed(True)
    want = calls + (mesh.size - 1) * (calls // 2)
    if any(float(v) != want for v in out):
        raise AssertionError(f"replica_max: {[float(v) for v in out]}, "
                             f"want {want} on every replica")
    host0, dev0, _ = timed(False)
    return dict(calls=calls, host_us=(host1 - host0) / calls * 1e3,
                device_us=(dev1 - dev0) / calls * 1e3, host_ms=host1,
                host_ms_without=host0, device_ms=dev1,
                device_ms_without=dev0)


@contextmanager
def counts_kept(nms_cuda, csp_cuda):
    """K1's and K2's launch counts after the block as they were before it
    (its launches check a kernel, they are not the main path's)."""
    counts = k_counts(nms_cuda, csp_cuda)
    try:
        yield
    finally:
        nms_cuda.greedy_nms_mask_cuda.launches = counts[0]
        csp_cuda.fused_csp_stage_cuda.launches = counts[1]


class LookupModel(torch.nn.Module):
    """A stand-in detector: each image's raw predictions [N, 85], looked up
    by the image's first byte (tests/test_torch_mesh.py's)."""

    def __init__(self, preds: torch.Tensor):
        super().__init__()
        self.register_buffer("preds", preds)

    def forward(self, x):
        return self.preds[torch.round(x[:, 0, 0, 0] * 255).long()]


# the span case's postprocess (tests/test_torch_mesh.py's TEST keys)
MESH_SPAN_TEST = {"IMGSIZE": 64, "PRE_NMS_TOPK": 64, "MAX_DETS": 50,
                  "CONFTHRE": 0.05, "NMSTHRE": 0.45}


def span_case(n_boxes=64, classes=80):
    """tests/test_torch_mesh.py's _span_case: 8 images (ids 1-8), the first
    four with boxes ~3e5 px from the origin, the last four with
    overlapping boxes inside 64 px. The whole batch's class-offset span
    (~6e5) puts the small boxes of class 79 near 5e7, where float32's
    spacing is 4 px, and so changes their IoUs: the NMS keeps other boxes
    than under their own shard's span (~130)."""
    rng = np.random.default_rng(5)
    preds = np.zeros((9, n_boxes, 5 + classes), np.float32)
    for i in range(1, 9):
        centre = (rng.uniform(2.9e5, 3.1e5, (n_boxes, 2)) if i <= 4 else
                  rng.uniform(20, 44, (n_boxes, 2)))
        wh = rng.uniform(8, 16, (n_boxes, 2))
        preds[i, :, :4] = np.concatenate([centre, wh], -1)
        preds[i, :, 4] = rng.uniform(0.3, 1.0, n_boxes)
        cls = rng.integers(classes - 4, classes, n_boxes)
        preds[i, np.arange(n_boxes), 5 + cls] = rng.uniform(0.5, 1.0,
                                                            n_boxes)
    images = np.zeros((8, 64, 64, 3), np.uint8)
    images[:, 0, 0, 0] = np.arange(1, 9)
    return LookupModel(torch.from_numpy(preds)), images


def mesh_span_check(cfg_cls, Predictor, mesh, nms_cuda):
    """The NMS span taken across the replicas on the card, K1 included: on
    ``span_case``'s batch the mesh's rows equal the one-replica
    predictor's on the whole batch bit for bit, and the far shard's own
    span (its four images alone) gives other rows, so a span taken per
    shard fails the check."""
    model, images = span_case()
    model = model.cuda()
    cfg = cfg_cls.from_dict({"TEST": dict(MESH_SPAN_TEST)})

    def predictor(batch, **kw):
        return Predictor(cfg, model=model, img_size=64, batch_size=batch,
                         **kw)

    full = predictor(8, device="cuda")(images)
    shard = predictor(4, device="cuda")(images[4:])
    if np.array_equal(shard[1], full[1][4:]):
        raise AssertionError("span case: the near shard's own span gives the "
                             "whole batch's rows on the card")
    before = nms_cuda.greedy_nms_mask_cuda.launches
    got = predictor(8, mesh=mesh)(images)
    k1 = nms_cuda.greedy_nms_mask_cuda.launches - before
    equal = all(np.array_equal(g, w) for g, w in zip(got, full))
    row = dict(k1=k1, valid=int(got[1].sum()), bit_equal=equal,
               shard_alone_differs_at=int((shard[1] != full[1][4:]).sum()))
    log(f"[mesh] span case (far and near shards) on {mesh.size} replicas: "
        f"{row}")
    if k1 != mesh.size or not equal:
        raise AssertionError(f"span case: the mesh's rows differ from one "
                             f"replica's on the whole batch, or K1 ran "
                             f"{k1} times: {row}")
    return row


# The dynamic int8 abs-max across the replicas on the card: float32, int8
# span full (every conv int8 but the stem's and the head's last), bright
# noise in the first shard and dark images (values 0-31 / 32) in the
# second, whose own abs-max is far below the batch's. The mesh's decoded
# forward on the dark rows against one replica's at b16, next to the same
# mesh with replica_max taken per shard: the mesh's error within
# MESH_AMAX_SHARE (mean) and MESH_AMAX_SHARE_MAX (max) of the per-shard
# one's. Not bit for bit: the float convolutions run at b8 on the mesh,
# where cuDNN may choose another algorithm than at b16, and a float32 ulp
# there can flip an int8 rounding downstream.
MESH_AMAX_SHARE = 0.01
MESH_AMAX_SHARE_MAX = 0.5


def mesh_amax_check(cfg_cls, Predictor, sd, mesh, size=608):
    from yolov4_tpu_torch.models import layers
    cfg = int8_cfg(cfg_cls, "int8", "full", dtype="float32", pallas=True)
    images = np.random.default_rng(44).integers(0, 256, (16, size, size, 3),
                                                dtype=np.uint8)
    images[8:] //= 32
    dark = slice(8, 16)
    with tf32_off():
        one = Predictor(cfg, state_dict=sd, img_size=size, batch_size=16,
                        device="cuda")
        pred = Predictor(cfg, model=one.model, img_size=size, batch_size=16,
                         mesh=mesh)
        want = one_forward(one, images)[dark]
        got = mesh_forward(pred, images)[dark]
        mesh_max = layers.replica_max
        layers.replica_max = lambda v: v
        try:
            local = mesh_forward(pred, images)[dark]
        finally:
            layers.replica_max = mesh_max
    e_mesh, e_local = pred_errors(got, want), pred_errors(local, want)
    row = dict(bit_equal=bool(torch.equal(got, want)), error=e_mesh,
               per_shard_error=e_local)
    log(f"[mesh] int8 abs-max case (bright and dark shards, float32, span "
        f"full) on {mesh.size} replicas, dark rows against one replica at "
        f"b16: {row}")
    for key, v in e_mesh.items():
        share = MESH_AMAX_SHARE_MAX if "max" in key else MESH_AMAX_SHARE
        if not (e_local[key] > 0 and v <= share * e_local[key]):
            raise AssertionError(f"int8 abs-max case: {key} {v:.4g} against "
                                 f"{e_local[key]:.4g} with per-shard maxima "
                                 f"(at most {share}x)")
    del one, pred
    torch.cuda.empty_cache()
    return row


def mesh_timing(pred, images):
    """(ms, device ms) of one dispatch of a host batch: CUDA events around
    the call, the host's enqueue included; then behind a spin kernel
    queued ahead, the card alone."""
    ms = cuda_ms(lambda: pred.dispatch(images), iters=10)
    device_ms = cuda_ms(lambda: pred.dispatch(images), iters=10,
                        queue_ahead=True, spin_cycles=RUN_SPIN_CYCLES)
    return ms, device_ms


def mesh_serve(cfg, sd, mesh, kernels, report):
    """ServingRuntime(mesh=...) with buckets 608 and 416 sharing the
    replicas' weights, over HTTP: K1 once and K2 3 times per replica per
    batch, every response equal to the direct mesh predictor's rows on the
    same batches, requests/s."""
    from yolov4_tpu_torch.serve import ServingRuntime
    runtime = ServingRuntime(cfg, state_dict=sd, sizes=list(SERVE_SIZES),
                             batch_size=16, conf_thre=MESH_CONF, mesh=mesh)
    preds = {s: b.predictor for s, b in runtime.buckets.items()}
    shared = all(preds[608].replicas[d] is preds[416].replicas[d]
                 for d in mesh.distinct_devices)
    if not shared:
        raise AssertionError("the mesh's buckets hold weights of their own")
    # K2 and K1 on the inputs each replica of the 416 bucket gives them
    imgs416 = np.random.default_rng(45).integers(0, 256, (16, 416, 416, 3),
                                                 dtype=np.uint8)
    inputs416 = kernel_inputs(lambda: preds[416](imgs416), *kernels,
                              "mesh 416/b16 serving bucket", 3 * mesh.size,
                              mesh.size)
    runtime.start(warmup=True)
    logs = {s: BatchLog(p) for s, p in preds.items()}
    try:
        reqs = serve_requests(MESH_SERVE_REQUESTS, seed=41)
        bodies, m, k1, k2, conv = run_traffic(runtime, reqs, kernels,
                                              "mesh runtime")
        batches, n = m["batches"], mesh.size
        if (k1, k2) != (n * batches, 3 * n * batches):
            raise AssertionError(f"mesh serving: K1 {k1}, K2 {k2} launches "
                                 f"for {batches} batches on {n} replicas")
        wants = [None] * len(reqs)
        for size in SERVE_SIZES:
            preds[size].dispatch = logs[size].dispatch
            idx = [i for i, r in enumerate(reqs) if r[1] == size]
            for i, want in zip(idx, expected_responses(
                    runtime, preds[size], logs[size].batches,
                    [reqs[i] for i in idx])):
                wants[i] = want
        m["detections"] = check_responses(bodies, reqs, wants, "mesh")
        log(f"[mesh] serving on {n} replicas: every response equals the "
            f"direct mesh predictor's rows ({m['detections']} detections)")
    finally:
        runtime.close()
    report["mesh_serve"] = dict(m, k1=k1, k2=k2, conv=conv, replicas=n,
                                kernel_inputs=inputs416)
    del runtime, preds
    torch.cuda.empty_cache()
    return k1, k2


def phase_mesh(cfg_cls, build_model, Predictor, nms_cuda, csp_cuda, smi,
               report):
    """Phase 17; returns the (K1, K2) launches of its main paths, then
    phase 7's weights, the batch and the two-replica mesh's detections on
    it (phase 18's reference)."""
    from yolov4_tpu_torch.models.layers import quant_sites
    from yolov4_tpu_torch.ops import int8 as int8_mod
    from yolov4_tpu_torch.parallel.mesh import create_mesh
    t_phase = time.time()
    kernels = (nms_cuda, csp_cuda)
    sd = int8_weights(cfg_cls, build_model)
    cfg = int8_cfg(cfg_cls, "none", pallas=True)
    images = np.random.default_rng(43).integers(0, 256, (16, 608, 608, 3),
                                                dtype=np.uint8)
    meshes = [("two replicas on cuda:0", create_mesh(["cuda:0"] * 2))]
    if torch.cuda.device_count() > 1:
        meshes.append((f"every card ({torch.cuda.device_count()})",
                       create_mesh()))
    one = Predictor(cfg, state_dict=sd, img_size=608, batch_size=16,
                    conf_thre=MESH_CONF, device="cuda")
    one.warmup()
    rows, k1, k2, timing = [], 0, 0, {}
    for label, mesh in meshes:
        # the replicas on one.model's card run one.model itself
        pred = Predictor(cfg, model=one.model, img_size=608, batch_size=16,
                         conf_thre=MESH_CONF, mesh=mesh)
        pred.warmup()
        row, raw, raw_one, got = mesh_case(label, pred, one, images,
                                           kernels, 3)
        if not rows:
            # phase 18 holds the ranks' rows against the two replicas'
            mesh_rows = got
        if row["min_match_share"] < MESH_MATCH_SHARE:
            raise AssertionError(f"{label}: an image shares only "
                                 f"{row['min_match_share']:.3f} of its "
                                 "detections with one replica's")
        k1, k2 = k1 + row["k1"], k2 + row["k2"]
        # K2 and K1 on the inputs each replica gives them (b8 shards)
        row["kernel_inputs"] = kernel_inputs(
            lambda: pred(images), nms_cuda, csp_cuda, f"{label} 608/b16",
            3 * mesh.size, mesh.size)
        # in turns: one replica, the mesh, the mesh, one replica
        for name, p in (("one", one), ("mesh", pred), ("mesh", pred),
                        ("one", one)):
            timing.setdefault((label, name), []).append(
                mesh_timing(p, images))
        row["ms"], row["device_ms"] = (
            [t[i] for t in timing[(label, "mesh")]] for i in (0, 1))
        row["one_ms"], row["one_device_ms"] = (
            [t[i] for t in timing[(label, "one")]] for i in (0, 1))
        row["replica_max"] = cost = replica_max_cost(mesh)
        log(f"[mesh] {smi}: 608/b16 bf16 PALLAS_CSP per batch (dispatch "
            f"of a host batch), in turns: one replica {row['one_ms']} ms, "
            f"device {row['one_device_ms']} ms; {label} {row['ms']} ms, "
            f"device {row['device_ms']} ms; one replica_max "
            f"{cost['host_us']:.1f} us of host time, {cost['device_us']:.1f} "
            f"us of device time")
        rows.append(row)
        del pred, raw, raw_one
    # int8 span full on the two-replica mesh: held against one replica with
    # phase 15's tolerance (INT8_TOL_VS_CPU): the mesh's int8 error against
    # the one-replica bf16 forward within that factor of one replica's own
    base = one_forward(one, images)
    del one
    torch.cuda.empty_cache()
    cfg8 = int8_cfg(cfg_cls, "int8", "full", pallas=True)
    one8 = Predictor(cfg8, state_dict=sd, img_size=608, batch_size=16,
                     conf_thre=MESH_CONF, device="cuda")
    mesh8 = Predictor(cfg8, model=one8.model, img_size=608, batch_size=16,
                      conf_thre=MESH_CONF, mesh=meshes[0][1])
    one8.warmup()
    mesh8.warmup()
    sites = len(quant_sites(one8.model))
    row8, raw8, raw8_one, _ = mesh_case("int8 span full, two replicas",
                                        mesh8, one8, images, kernels, 0,
                                        int8_mod)
    if row8["int8"] != sites * mesh8.mesh.size:
        raise AssertionError(f"int8 mesh: {row8['int8']} products for "
                             f"{sites} sites on {mesh8.mesh.size} replicas")
    e_mesh = pred_errors(raw8[:len(images)], base)
    e_one = pred_errors(raw8_one, base)
    ulp = 2.0 ** (math.floor(math.log2(float(base.abs().max()))) - 7)
    for key in e_one:
        extra = ulp if key.endswith("max") or key.endswith("max_px") else 0.0
        if e_mesh[key] > INT8_TOL_VS_CPU * e_one[key] + extra:
            raise AssertionError(f"int8 mesh: {key} error against bf16 "
                                 f"{e_mesh[key]:.4g} exceeds "
                                 f"{INT8_TOL_VS_CPU}x one replica's "
                                 f"{e_one[key]:.4g} (+ {extra:.4g})")
    row8.update(error_vs_bf16=e_mesh, one_error_vs_bf16=e_one, sites=sites)
    log(f"[mesh] int8 span full: error against the bf16 forward, mesh "
        f"{e_mesh}, one replica {e_one}")
    k1, k2 = k1 + row8["k1"], k2 + row8["k2"]
    del one8, mesh8, raw8, raw8_one, base
    torch.cuda.empty_cache()
    # the maxima across the replicas on shards whose own maxima differ
    with counts_kept(nms_cuda, csp_cuda):
        span = mesh_span_check(cfg_cls, Predictor, meshes[0][1], nms_cuda)
        amax = mesh_amax_check(cfg_cls, Predictor, sd, meshes[0][1])
    serve_k1, serve_k2 = mesh_serve(cfg, sd, meshes[0][1], kernels, report)
    report["mesh"] = dict(card=smi, rows=rows, int8=row8, span_case=span,
                          amax_case=amax, seconds=time.time() - t_phase)
    log(f"[mesh] phase 17 in {report['mesh']['seconds']:.1f}s")
    return k1 + serve_k1, k2 + serve_k2, sd, images, mesh_rows


# --------------------------------------------------------------------------
# Phase 18: the predictor over torchrun's ranks (Predictor(group=...)) and
# the analysis tools

RANKS_LIMIT_S = 300
GROUP_MAX_CALLS = 200


def group_max_cost(group, calls=GROUP_MAX_CALLS):
    """What one ``replica_max`` costs inside ``group_scope(group)``, every
    rank of the group running it together: ``calls`` maxima of a 0-d
    tensor on the card against the same loop without them, per call; host
    us from the loop's wall time (ending in a synchronize), device us from
    CUDA events with a spin kernel queued ahead. At every other call the
    ranks' values differ (rank r adds r), so each rank must end at ``calls
    + (world - 1) * (calls // 2)``. Gloo copies the value to the host and
    back, so there the device time holds the host's round trips too."""
    import torch.distributed as tdist
    from yolov4_tpu_torch.ops.replica import group_scope, replica_max
    rank, world = tdist.get_rank(group), tdist.get_world_size(group)

    def timed(with_max, spin):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if spin:
            torch.cuda._sleep(RUN_SPIN_CYCLES)
        start.record()
        t0 = time.perf_counter()
        v = torch.zeros((), device="cuda")
        with torch.inference_mode(), group_scope(group):
            for step in range(calls):
                v = v + (1 + rank * (step % 2))
                if with_max:
                    v = replica_max(v)
        end.record()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, start.elapsed_time(end), \
            float(v)

    timed(True, False)
    host1, _, v = timed(True, False)
    want = calls + (world - 1) * (calls // 2)
    if v != want:
        raise AssertionError(f"group max on rank {rank}: {v}, want {want}")
    host0 = timed(False, False)[0]
    dev1, dev0 = timed(True, True)[1], timed(False, True)[1]
    return dict(backend=str(tdist.get_backend(group)), world=world,
                calls=calls, host_us=(host1 - host0) / calls * 1e3,
                device_us=(dev1 - dev0) / calls * 1e3)


def rows_of(out):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in out]


def group_task(rank, sd_path, images_path, amax_path, root):
    """Phase 18 on one of two gloo ranks sharing the card: (a) the
    full-width Predictor(group=...) at 608, b8 a rank, bf16, PALLAS_CSP,
    on its rows of phase 17's batch, K1's and K2's counts set to 0 just
    before and read just after; (b) the span case's rows with the group
    and alone; (c) the bright/dark batch in float32 int8 span full: the
    decoded forward with the group and alone, and the detections; (d) an
    int8_static calibration over the ranks; (e) Trainer.evaluate over the
    ranks on phase 12's synthetic val2017, counted as (a); (f) the cost of
    one group max on gloo."""
    from yolov4_tpu_torch.config import Config
    from yolov4_tpu_torch.engine.predictor import Predictor, model_input
    from yolov4_tpu_torch.engine.trainer import Trainer
    from yolov4_tpu_torch.ops import csp_cuda, nms_cuda
    from yolov4_tpu_torch.ops.replica import group_scope
    from yolov4_tpu_torch.parallel import dist
    group = dist.world_group()
    sd = torch.load(sd_path, weights_only=True)
    mine = slice(8 * rank, 8 * rank + 8)
    out = {}

    def counted(fn):
        torch.cuda.synchronize()
        nms_cuda.greedy_nms_mask_cuda.launches = 0
        csp_cuda.fused_csp_stage_cuda.launches = 0
        res = fn()
        torch.cuda.synchronize()
        return res, k_counts(nms_cuda, csp_cuda)

    pred = Predictor(int8_cfg(Config, "none", pallas=True), state_dict=sd,
                     img_size=608, batch_size=8, conf_thre=MESH_CONF,
                     device="cuda", group=group)
    pred.warmup()
    images = np.load(images_path)
    rows, (k1, k2) = counted(lambda: pred(images[mine]))
    out["main"] = dict(rows=rows_of(rows), k1=k1, k2=k2)
    del pred
    with counts_kept(nms_cuda, csp_cuda):
        model, span_images = span_case()
        model = model.cuda()
        cfg = Config.from_dict({"TEST": dict(MESH_SPAN_TEST)})
        half = span_images[4 * rank:4 * rank + 4]
        out["span"] = {name: rows_of(Predictor(
            cfg, model=model, img_size=64, batch_size=4, device="cuda",
            **kw)(half)) for name, kw in (("group", {"group": group}),
                                          ("alone", {}))}
        amax_images = np.load(amax_path)[mine]
        with tf32_off():
            p8 = Predictor(int8_cfg(Config, "int8", "full", dtype="float32",
                                    pallas=True), state_dict=sd,
                           img_size=608, batch_size=8, conf_thre=MESH_CONF,
                           device="cuda", group=group)
            x = p8.upload(amax_images).permute(0, 3, 1, 2)
            with torch.inference_mode():
                with group_scope(group):
                    fwd = p8.model(model_input(p8.model, x))
                alone = p8.model(model_input(p8.model, x))
            out["amax"] = dict(forward=fwd.cpu(), alone=alone.cpu(),
                               rows=rows_of(p8(amax_images)))
        del p8, x, fwd, alone
        ps = Predictor(int8_cfg(Config, "int8_static", pallas=True),
                       state_dict=sd, img_size=608, batch_size=8,
                       device="cuda", group=group)
        ps.calibrate(images[mine])
        out["static"] = {site: {k: v.cpu() for k, v in e.items()}
                         for site, e in ps.quant_state.items()}
        del ps
        torch.cuda.empty_cache()
    trainer = Trainer(Config.from_dict(ddp_trainer_cfg(str(Path(root)
                                                           / "eval"))),
                      root, evaluate_only=True, device="cuda")
    try:
        out["in_group"] = trainer.predictor.group is group
        (ap, ap50), (k1, k2) = counted(trainer.evaluate)
    finally:
        trainer.close()
    out["evaluate"] = dict(ap=ap, ap50=ap50, k1=k1, k2=k2)
    del trainer
    torch.cuda.empty_cache()
    out["group_max"] = group_max_cost(group)
    return out


DDP_TASKS["group"] = group_task


def ranks_references(cfg_cls, Predictor, sd, mesh, amax_images, images):
    """What the ranks are held against, on the two-replica mesh of phase
    17 (global batch 16, b8 a replica) and one predictor: the span case's
    rows on the whole batch and the near shard's alone; the bright/dark
    batch's decoded forward and detections; int8_static scales calibrated
    on the whole batch."""
    from yolov4_tpu_torch.models import layers
    model, span_images = span_case()
    model = model.cuda()
    cfg = cfg_cls.from_dict({"TEST": dict(MESH_SPAN_TEST)})
    ref = {"span": Predictor(cfg, model=model, img_size=64, batch_size=8,
                             device="cuda")(span_images)}
    with tf32_off():
        cfg8 = int8_cfg(cfg_cls, "int8", "full", dtype="float32",
                        pallas=True)
        pred = Predictor(cfg8, state_dict=sd, img_size=608, batch_size=16,
                         conf_thre=MESH_CONF, mesh=mesh)
        ref["amax_forward"] = mesh_forward(pred, amax_images).cpu()
        ref["amax_rows"] = pred(amax_images)
        mesh_max = layers.replica_max
        layers.replica_max = lambda v: v
        try:
            ref["amax_per_shard"] = mesh_forward(pred, amax_images).cpu()
        finally:
            layers.replica_max = mesh_max
    del pred
    pred = Predictor(int8_cfg(cfg_cls, "int8_static", pallas=True),
                     state_dict=sd, img_size=608, batch_size=16, mesh=mesh)
    pred.calibrate(images)
    ref["static"] = {site: {k: v.cpu() for k, v in e.items()}
                     for site, e in pred.quant_state.items()}
    del pred
    torch.cuda.empty_cache()
    return ref


def check_ranks(ranks, ref, mesh_rows, report):
    """The two ranks' results against the references: returns the report's
    row."""
    def joined(parts):
        return [torch.cat(p).numpy() for p in zip(*parts)]

    row = {}
    main = joined([r["main"]["rows"] for r in ranks])
    row["main_bit_equal_to_mesh"] = all(
        np.array_equal(g, w) for g, w in zip(main, mesh_rows))
    row["main_launches"] = [(r["main"]["k1"], r["main"]["k2"]) for r in ranks]
    if not row["main_bit_equal_to_mesh"] or any(
            c != (1, 3) for c in row["main_launches"]):
        raise AssertionError(f"ranks: rows bit-equal to phase 17's mesh "
                             f"{row['main_bit_equal_to_mesh']}, K1/K2 a rank "
                             f"{row['main_launches']} (want 1, 3)")
    span = joined([r["span"]["group"] for r in ranks])
    near_alone = ranks[1]["span"]["alone"]
    row["span"] = dict(
        bit_equal=all(np.array_equal(g, w) for g, w in zip(span, ref["span"])),
        alone_differs=any(not np.array_equal(a.numpy(), w[4:])
                          for a, w in zip(near_alone, ref["span"])))
    fwd = torch.cat([r["amax"]["forward"] for r in ranks])
    dark = slice(8, 16)
    amax_rows = joined([r["amax"]["rows"] for r in ranks])
    row["amax"] = dict(
        forward_bit_equal=bool(torch.equal(fwd, ref["amax_forward"])),
        rows_bit_equal=all(np.array_equal(g, w)
                           for g, w in zip(amax_rows, ref["amax_rows"])),
        dark_alone_differs=not torch.equal(ranks[1]["amax"]["alone"],
                                           ref["amax_forward"][dark]),
        dark_alone_is_per_shard=bool(torch.equal(
            ranks[1]["amax"]["alone"], ref["amax_per_shard"][dark])),
        dark_alone_max_err=float((ranks[1]["amax"]["alone"]
                                  - ref["amax_forward"][dark]).abs().max()))
    gaps = [float(((r["static"][site]["amax"] - e["amax"]).abs()
                   / e["amax"].abs().clamp_min(1e-30)).max())
            for r in ranks for site, e in ref["static"].items()]
    row["static"] = dict(
        sites=len(ref["static"]),
        bit_equal=all(torch.equal(r["static"][site][k], e[k])
                      for r in ranks for site, e in ref["static"].items()
                      for k in ("amax", "wq", "sw")),
        max_rel_amax_gap=max(gaps))
    row["evaluate"] = [r["evaluate"] for r in ranks]
    row["group_max_gloo"] = ranks[0]["group_max"]
    log(f"[ranks] two gloo ranks on one card, 608/b8 a rank bf16 PALLAS_CSP:"
        f" rows bit-equal to phase 17's two-replica mesh, K1/K2 a rank "
        f"{row['main_launches']}; span case {row['span']}; bright/dark int8 "
        f"span full {row['amax']}; int8_static {row['static']}; "
        f"Trainer.evaluate {row['evaluate']}; one group max on gloo "
        f"{row['group_max_gloo']}")
    bad = [k for k, ok in (
        ("span rows", row["span"]["bit_equal"]),
        ("span alone differs", row["span"]["alone_differs"]),
        ("amax forward", row["amax"]["forward_bit_equal"]),
        ("amax rows", row["amax"]["rows_bit_equal"]),
        ("amax alone differs", row["amax"]["dark_alone_differs"]),
        ("amax alone is the per-shard mesh",
         row["amax"]["dark_alone_is_per_shard"]),
        ("int8_static scales", row["static"]["bit_equal"]),
        ("trainer group", all(r["in_group"] for r in ranks)),
        ("trainer AP", ranks[0]["evaluate"]["ap"] == ranks[1]["evaluate"]["ap"]
         and ranks[0]["evaluate"]["ap50"] == ranks[1]["evaluate"]["ap50"]),
        ("trainer launches", all(r["evaluate"]["k1"] == 2
                                 and r["evaluate"]["k2"] == 6
                                 for r in ranks))) if not ok]
    if bad:
        raise AssertionError(f"ranks: {bad} failed: {row}")
    report["ranks"] = row
    return row


def phase_ranks_nccl(cfg_cls, Predictor, sd, images, work, kernels):
    """NCCL at world size 1: Predictor(group=...) on phase 17's batch at
    b16 bit-equal to the plain predictor, counted as the main path; one
    group max's cost on NCCL."""
    import os
    from yolov4_tpu_torch.parallel import dist
    nms_cuda, csp_cuda = kernels
    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0")
    dist.init_distributed(backend="nccl", device="cuda",
                          init_method=f"file://{work / 'rendezvous.nccl'}",
                          timeout_s=DDP_LIMIT_S)
    try:
        cfg = int8_cfg(cfg_cls, "none", pallas=True)
        plain = Predictor(cfg, state_dict=sd, img_size=608, batch_size=16,
                          conf_thre=MESH_CONF, device="cuda")
        grp = Predictor(cfg, model=plain.model, img_size=608, batch_size=16,
                        conf_thre=MESH_CONF, device="cuda",
                        group=dist.world_group())
        want = plain(images)
        grp.warmup()
        torch.cuda.synchronize()
        nms_cuda.greedy_nms_mask_cuda.launches = 0
        csp_cuda.fused_csp_stage_cuda.launches = 0
        got = grp(images)
        torch.cuda.synchronize()
        k1, k2 = k_counts(nms_cuda, csp_cuda)
        cost = group_max_cost(dist.world_group())
    finally:
        dist.shutdown()
        for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
            os.environ.pop(key, None)
    row = dict(bit_equal=all(np.array_equal(g, w) for g, w in zip(got, want)),
               k1=k1, k2=k2, group_max=cost)
    log(f"[ranks] NCCL world size 1: the group predictor against the plain "
        f"one at 608/b16 {row}")
    if not row["bit_equal"] or (k1, k2) != (1, 3):
        raise AssertionError(f"NCCL world size 1: {row}")
    del plain, grp
    torch.cuda.empty_cache()
    return row


def phase_tools(sd, kernels, smi, report):
    """The three analysis tools once at 608/b16 bf16 (their stdout kept in
    the report, their summaries logged); their launches are not the main
    path's."""
    from yolov4_tpu_torch.tools import act_bound, attr_trace, check_csp_fused
    out = {}
    with counts_kept(*kernels):
        for name, argv in (("default", ["--target", "serve"]),
                           ("pallas_csp", ["--target", "serve",
                                           "--pallas-csp"])):
            with captured_stdout() as text:
                res = attr_trace.main(argv + ["--top", "25"])
            out[f"attr_trace_{name}"] = res
            if res["unattributed_share"] >= 0.01:
                raise AssertionError(f"attr_trace {name}: "
                                     f"{res['unattributed_share']:.4f} of "
                                     "the device time unattributed")
            total = res["device_ms_per_iter"]
            if abs(sum(res["groups_ms_per_iter"].values()) - total) > \
                    1e-9 * total:
                raise AssertionError(f"attr_trace {name}: the groups do "
                                     "not add up to the traced total")
            top = list(res["groups_ms_per_iter"].items())[:12]
            log(f"[tools] {smi}: attr_trace Predictor.run 608/b16 bf16 "
                f"{name}: {total:.3f} ms device per call, unattributed "
                f"{100 * res['unattributed_share']:.4f}%, by "
                f"{res['attributed_by']}; top groups (depth 3) "
                + ", ".join(f"{g} {ms:.3f}" for g, ms in top))
        args = check_csp_fused.build_parser().parse_args(
            ["--iters", "10", "--windows", "3"])
        with captured_stdout():
            res = check_csp_fused.run(check_csp_fused.build_cfg(args), args,
                                      state_dict=sd)
        out["check_csp_fused"] = res
        if not (res["parity"]["within_tol"]
                and res["parity"]["tol"] == K2_TOL_BF16):
            raise AssertionError(f"check_csp_fused: {res['parity']}")
        log(f"[tools] {smi}: check_csp_fused 608/b16 bf16 on phase 7's "
            f"weights: parity {res['parity']}; plain "
            f"{res['plain_median_ms']:.3f} ms, fused "
            f"{res['fused_median_ms']:.3f} ms, plain / fused paired median "
            f"{res['paired_median_ratio']:.3f}")
        for name, argv in (("default", []), ("pallas_csp", ["--pallas-csp"])):
            with captured_stdout():
                res = act_bound.main(argv + ["--windows", "3"])
            out[f"act_bound_{name}"] = res
            log(f"[tools] {smi}: act_bound 608/b16 bf16 {name}: "
                f"{res['swapped']} Mish sites swapped, {res['kept_in_k2']} "
                f"kept in K2; mish {res['mish_median_ms']:.3f} ms, leaky "
                f"{res['leaky_median_ms']:.3f} ms, ceiling "
                f"{res['ceiling_ms']:.3f} ms")
    torch.cuda.empty_cache()
    report["tools"] = out


def phase_ranks(cfg_cls, Predictor, coco_ids, sd, images, mesh_rows,
                kernels, smi, report):
    """Phase 18; returns the (K1, K2) launches of its main paths: the
    ranks' group predictors and validations and the NCCL group
    predictor."""
    import os
    from yolov4_tpu_torch.parallel.mesh import create_mesh
    t0 = time.time()
    work = ROOT / "runs" / "chip_smoke_ranks"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    torch.save(sd, work / "sd.pt")
    np.save(work / "images.npy", images)
    amax_images = np.random.default_rng(44).integers(
        0, 256, (16, 608, 608, 3), dtype=np.uint8)
    amax_images[8:] //= 32
    np.save(work / "amax.npy", amax_images)
    write_val2017(work, coco_ids, DDP_VAL_IMAGES, seed=9)
    tasks = [("group", {"sd_path": str(work / "sd.pt"),
                        "images_path": str(work / "images.npy"),
                        "amax_path": str(work / "amax.npy"),
                        "root": str(work)})]
    procs = start_ranks(tasks, work)
    try:
        ref = ranks_references(cfg_cls, Predictor, sd,
                               create_mesh(["cuda:0"] * 2), amax_images,
                               images)
    finally:
        ranks = join_ranks(procs, tasks, work,
                           time.monotonic() + RANKS_LIMIT_S)["group"]
    row = check_ranks(ranks, ref, mesh_rows, report)
    row["nccl"] = phase_ranks_nccl(cfg_cls, Predictor, sd, images, work,
                                   kernels)
    row["ranks_seconds"] = time.time() - t0
    phase_tools(sd, kernels, smi, report)
    row["seconds"] = time.time() - t0
    log(f"[ranks] phase 18 in {row['seconds']:.1f}s (ranks and NCCL "
        f"{row['ranks_seconds']:.1f}s)")
    shutil.rmtree(work, ignore_errors=True)
    k1 = sum(r["main"]["k1"] + r["evaluate"]["k1"] for r in ranks)
    k2 = sum(r["main"]["k2"] + r["evaluate"]["k2"] for r in ranks)
    return k1 + row["nccl"]["k1"], k2 + row["nccl"]["k2"]


# --------------------------------------------------------------------------
# Phase 14: the classifier pretrainer (classify/, darknet_pretrain)

CLS_CLASSES = 4                 # (a), (b) and the CLI's ImageFolder
CLS_SMALL = 64                  # (a), (b): WIDTH 0.25 at 64x64, batch 4
CLS_BATCH, CLS_CROP = 128, 256  # (c): the reference's per-GPU batch, crop
CLS_TRAIN_PER_CLASS, CLS_VAL_PER_CLASS = 32, 8
CLS_LIMIT_S = 600               # (b)'s ranks and (d)'s CLI, each
# (d) runs ``python -m yolov4_tpu_torch.darknet_pretrain`` as -m does
# (runpy, with sys.argv and __main__ set), then prints this process's K1 and
# K2 counts as its last line
CLS_CLI = (
    "import json, runpy, sys\n"
    "from yolov4_tpu_torch.ops import csp_cuda, nms_cuda\n"
    "sys.argv[0] = 'darknet_pretrain'\n"
    "runpy.run_module('yolov4_tpu_torch.darknet_pretrain',"
    " run_name='__main__', alter_sys=True)\n"
    "print(json.dumps({'k1': nms_cuda.greedy_nms_mask_cuda.launches,"
    " 'k2': csp_cuda.fused_csp_stage_cuda.launches}))\n")


def cls_api():
    """The port's classifier functions phase 14 drives."""
    from yolov4_tpu_torch.classify.trainer import (classifier_lr_schedule,
                                                   make_cls_train_step,
                                                   normalize_images)
    from yolov4_tpu_torch.models.darknet import CSPDarknet53
    from yolov4_tpu_torch.models.layers import convert_sync_bn
    return SimpleNamespace(
        CSPDarknet53=CSPDarknet53, convert_sync_bn=convert_sync_bn,
        classifier_lr_schedule=classifier_lr_schedule,
        make_cls_train_step=make_cls_train_step,
        normalize_images=normalize_images)


def cls_two_steps(device, seed, batch_seed=21, dist=None, sync_bn=False):
    """Two Adam steps (lr 0.01 then 0.02: the warmup of base lr 0.05) of the
    WIDTH 0.25 classifier in float64 at 64x64, batch 4, from init ``seed``
    with BN re-drawn (redraw_bn), on ``device``; over the process group
    ``dist`` with its BNs synchronised when ``sync_bn``: (losses, initial
    state_dict, final state_dict) on the CPU, as train_two_steps.

    Adam's eps is 1e-2 here, as in tests/test_torch_classify.py: at the
    Trainer's 1e-8 each element steps by ~lr whatever its gradient's size,
    so the gate would read the relative error of the gradients that cancel
    to nearly 0 (on the card: 3.5e-10 of a tensor's largest change from the
    reference init, 1.95e-9 with BN re-drawn, against a 1e-9 tolerance)
    instead of the step's."""
    c = cls_api()
    model = c.CSPDarknet53(CLS_CLASSES, 0.25, 0.25,
                           generator=torch.Generator().manual_seed(seed))
    model.load_state_dict(redraw_bn(model.state_dict(),
                                    np.random.default_rng(seed)))
    model = model.to(device=device, dtype=torch.float64)
    if sync_bn:
        c.convert_sync_bn(model, dist)
    init = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    opt = torch.optim.Adam(model.parameters(), lr=0.0, betas=(0.9, 0.999),
                           eps=1e-2)
    step = c.make_cls_train_step(model, opt, c.classifier_lr_schedule(0.05, 1),
                                 dist=dist, sync_bn=sync_bn)
    from yolov4_tpu_torch.parallel.train_step import TrainState
    rng = np.random.default_rng(batch_seed)
    state = TrainState()
    losses = []
    for _ in range(2):
        u8 = torch.from_numpy(rng.integers(0, 256, (4, CLS_SMALL, CLS_SMALL,
                                                    3), np.uint8))
        labels = torch.from_numpy(rng.integers(0, CLS_CLASSES, 4))
        state = step(state, u8.to(device), labels.to(device))
        losses.append(float(state.loss))
    return losses, init, {k: v.detach().cpu() for k, v in
                          model.state_dict().items()}


def cls_param_names():
    return dict(cls_api().CSPDarknet53(CLS_CLASSES, 0.25,
                                       0.25).named_parameters())


def check_f64(res, label):
    if (res["loss_rel"] > TRAIN_F64_TOL_LOSS
            or res["worst_tensor_rel"] > TRAIN_F64_TOL_UPDATE_TENSOR
            or res["worst_buffer_rel"] > TRAIN_F64_TOL_BUF or res["unequal"]):
        raise AssertionError(f"{label}: card against CPU out of tolerance: "
                             f"{res}")
    return {k: res[k] for k in (
        "card_loss", "cpu_loss", "loss_rel", "update_l2_rel", "worst_tensor",
        "worst_tensor_rel", "worst_buffer_rel")}


def phase_cls_f64(report):
    """14a: two float64 classifier steps on the card against the CPU
    (agreed_cpu_run), TRAIN_F64_TOL_*."""
    cpu, cpu_runs = agreed_cpu_run(lambda: cls_two_steps("cpu", TRAIN_SEED))
    res = check_f64(compare_train_runs(
        cpu, cls_two_steps("cuda", TRAIN_SEED), cls_param_names()),
        "float64 classifier step")
    res["cpu_runs"] = cpu_runs
    log(f"[classify] WIDTH 0.25 f64 at {CLS_SMALL}, batch 4, Adam, 2 steps: "
        f"card vs CPU (its runs until two agree: {cpu_runs}) loss "
        f"{res['card_loss']} vs {res['cpu_loss']} ({res['loss_rel']:.3g} "
        f"apart, tol {TRAIN_F64_TOL_LOSS}), worst tensor {res['worst_tensor']}"
        f" {res['worst_tensor_rel']:.3g} of its largest change (tol "
        f"{TRAIN_F64_TOL_UPDATE_TENSOR}), BN buffers "
        f"{res['worst_buffer_rel']:.3g} (tol {TRAIN_F64_TOL_BUF})")
    report["classify"]["f64"] = res


def cls_sync_task(rank):
    """14b on one rank: two float64 SyncBN steps over the group on the card,
    then on the CPU (agreed_cpu_run), and the same two per replica on the
    card; K1's and K2's counts set to 0 just before and read just after."""
    from yolov4_tpu_torch.ops import csp_cuda, nms_cuda
    from yolov4_tpu_torch.parallel import dist
    group = dist.world_group()
    nms_cuda.greedy_nms_mask_cuda.launches = 0
    csp_cuda.fused_csp_stage_cuda.launches = 0

    def run(device, sync):
        return cls_two_steps(device, TRAIN_SEED, batch_seed=21 + rank,
                             dist=group, sync_bn=sync)
    out = {"cuda": run("cuda", True)}
    out["cpu"], out["cpu_runs"] = agreed_cpu_run(lambda: run("cpu", True),
                                                 group=group)
    out["replica"] = run("cuda", False)
    out["k1"] = nms_cuda.greedy_nms_mask_cuda.launches
    out["k2"] = csp_cuda.fused_csp_stage_cuda.launches
    return out


DDP_TASKS["cls_sync"] = cls_sync_task


def check_cls_sync(ranks, report):
    """14b: each rank's card run against its CPU run within
    TRAIN_F64_TOL_*; the ranks' states equal bit for bit on the card and on
    the CPU; the synchronised running statistics not the per-replica
    run's."""
    params = cls_param_names()
    res = []
    for rank, out in enumerate(ranks):
        res.append(check_f64(compare_train_runs(out["cpu"], out["cuda"],
                                                params),
                             f"two-rank SyncBN step, rank {rank}"))
        res[-1]["cpu_runs"] = out["cpu_runs"]
    for dev in ("cuda", "cpu"):
        a, b = (out[dev][2] for out in ranks)
        unequal = [k for k, v in a.items() if not torch.equal(v, b[k])]
        if unequal:
            raise AssertionError(f"two-rank SyncBN step on {dev}: ranks "
                                 f"differ in {unequal[:5]}")
    synced, replica = ranks[0]["cuda"][2], ranks[0]["replica"][2]
    gap = max(float((v - replica[k]).abs().max() / v.abs().max())
              for k, v in synced.items() if k.endswith("running_var"))
    if not gap > 1e3 * TRAIN_F64_TOL_BUF:
        raise AssertionError(f"SyncBN running variances {gap} from the "
                             "per-replica run's")
    launches = [(r["k1"], r["k2"]) for r in ranks]
    seconds = max(r["seconds"] for r in ranks)
    log(f"[classify] SyncBN in 2 ranks on the one card over gloo, WIDTH 0.25"
        f" f64 at {CLS_SMALL}, batch 4 per rank, 2 Adam steps, against the "
        f"same 2 ranks on the CPU (runs until two agree: "
        f"{[r['cpu_runs'] for r in res]}): loss "
        f"{[r['loss_rel'] for r in res]} apart, worst tensor "
        f"{[r['worst_tensor_rel'] for r in res]} of its largest change, BN "
        f"buffers {[r['worst_buffer_rel'] for r in res]}; the ranks equal bit"
        f" for bit; running variances {gap:.3g} (relative) from the "
        f"per-replica run's; K1/K2 per rank {launches}; {seconds:.1f}s")
    report["classify"]["sync_bn"] = {"ranks": res, "replica_gap": gap,
                                     "launches": launches,
                                     "seconds": seconds}
    return launches


def phase_cls_timed(report, smi):
    """14c: the full-width step (1000 classes, crop 256, batch CLS_BATCH,
    halved while it does not fit), bf16 autocast over float32 weights,
    Adam: 3 warm steps, then 20 between CUDA events."""
    from yolov4_tpu_torch.parallel.train_step import TrainState
    from yolov4_tpu_torch.tools.profile_train import forward_conv_flops
    c = cls_api()
    batch = CLS_BATCH
    while True:
        model = step = None
        try:
            model = c.CSPDarknet53(1000).to("cuda").to(
                memory_format=torch.channels_last)
            opt = torch.optim.Adam(model.parameters(), lr=0.0,
                                   betas=(0.9, 0.999), eps=1e-8)
            step = c.make_cls_train_step(
                model, opt, c.classifier_lr_schedule(0.1 * batch / 256, 10000),
                torch.bfloat16)
            gen = torch.Generator(device="cuda").manual_seed(3)
            u8 = torch.randint(0, 256, (batch, CLS_CROP, CLS_CROP, 3),
                               dtype=torch.uint8, device="cuda",
                               generator=gen)
            labels = torch.randint(0, 1000, (batch,), device="cuda",
                                   generator=gen)
            state = TrainState()
            for _ in range(3):
                state = step(state, u8, labels)
            torch.cuda.synchronize()
            break
        except torch.cuda.OutOfMemoryError:
            del model, step
            torch.cuda.empty_cache()
            log(f"[classify] batch {batch} does not fit; halving")
            batch //= 2
    params = sum(p.numel() for p in model.parameters())
    flops = 3.0 * forward_conv_flops(model, c.normalize_images(u8[:1])) * batch
    torch.cuda.reset_peak_memory_stats()
    n = 20
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        state = step(state, u8, labels)
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / n
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    share = flops / (step_ms * 1e-3) / PEAK_BF16_OPS
    loss = float(state.loss)
    if not np.isfinite(loss):
        raise AssertionError(f"full-width classifier step loss {loss}")
    log(f"[classify] {smi}: CSPDarknet53 {params:,} params, 1000 classes, "
        f"crop {CLS_CROP}, batch {batch}, bf16 autocast, f32 weights, Adam: "
        f"{step_ms:.3f} ms per step ({batch * 1e3 / step_ms:.1f} img/s), "
        f"peak memory {peak_gib:.2f} GiB, {flops / 1e12:.3f} TFLOP per step "
        f"({share:.2%} of the bf16 dense peak), loss {loss:.4f}")
    del model, step, state, u8
    torch.cuda.empty_cache()
    report["classify"]["timed"] = dict(
        params=params, batch=batch, crop=CLS_CROP, step_ms=step_ms,
        img_s=batch * 1e3 / step_ms, peak_memory_gib=peak_gib,
        train_tflop=flops / 1e12, flop_share_bf16=share, card=smi)


def write_imagefolder(root, seed=13, n_train=CLS_TRAIN_PER_CLASS,
                      n_val=CLS_VAL_PER_CLASS):
    """CLS_CLASSES classes told apart by their colour (red, green, blue,
    grey, with per-pixel noise and a random tint), ``n_train`` train and
    ``n_val`` val JPEGs each at 288x320, written with PIL: the CLI's short
    run can learn them."""
    from PIL import Image
    rng = np.random.default_rng(seed)
    colours = np.array([[200, 40, 40], [40, 200, 40], [40, 40, 200],
                        [120, 120, 120]])
    for split, n in (("train", n_train), ("val", n_val)):
        for cls in range(CLS_CLASSES):
            d = Path(root) / split / f"class{cls}"
            d.mkdir(parents=True)
            for i in range(n):
                img = (colours[cls] + rng.integers(-30, 30, 3)
                       + rng.integers(-40, 40, (288, 320, 3)))
                Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
                    d / f"{i}.jpg", quality=90)


def start_cls_cli(work, args, name):
    """The CLI (CLS_CLI) with ``args``, its output to <name>.log."""
    import os
    logf = open(work / f"{name}.log", "w")
    proc = subprocess.Popen([sys.executable, "-c", CLS_CLI, *args], cwd=ROOT,
                            stdout=logf, stderr=subprocess.STDOUT,
                            env=dict(os.environ))
    logf.close()
    return proc, time.time()


def finish_cls_cli(work, cli, name, deadline):
    """Wait for a CLI run; returns (its log, its (K1, K2) launches,
    seconds). Fails unless it exited 0."""
    rc, seconds = wait_cli(cli, deadline)
    text = (work / f"{name}.log").read_text()
    if rc != 0:
        raise AssertionError(f"darknet_pretrain ({name}) exited {rc} after "
                             f"{seconds:.1f}s:\n{text[-3000:]}")
    counts = json.loads(text.strip().splitlines()[-1])
    return text, (counts["k1"], counts["k2"]), seconds


def check_cls_cli(work, text, seconds, report):
    """14d's training checks: finite losses, the second epoch's mean below
    the first's; metrics.jsonl and both checkpoints written."""
    import os
    out = work / "out"
    with open(out / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    losses = [r["loss"] for r in rows if r["kind"] == "train"]
    evals = [r for r in rows if r["kind"] == "eval"]
    n_steps = 2 * CLS_CLASSES * CLS_TRAIN_PER_CLASS // 16
    written = sorted(os.listdir(out))
    if not {"checkpoint.pth", "model_best.pth", "metrics.jsonl",
            "stdout.log"} <= set(written) or len(evals) != 2:
        raise AssertionError(f"darknet_pretrain wrote {written}, eval "
                             f"records {evals}\n{text[-3000:]}")
    half = n_steps // 2
    if not (len(losses) == n_steps and np.isfinite(losses).all()
            and np.mean(losses[half:]) < np.mean(losses[:half])):
        raise AssertionError(f"darknet_pretrain losses {losses}")
    img_s = [r["img_s"] for r in rows if r["kind"] == "train"]
    log(f"[classify] python -m yolov4_tpu_torch.darknet_pretrain, full "
        f"width, {CLS_CLASSES} classes, {CLS_CLASSES * CLS_TRAIN_PER_CLASS} "
        f"train / {CLS_CLASSES * CLS_VAL_PER_CLASS} val JPEGs, -b 16, 2 "
        f"epochs: {seconds:.1f}s, loss {' '.join(f'{v:.3f}' for v in losses)}"
        f", prec1 {[e['prec1'] for e in evals]}, img/s (print-freq 1) "
        f"{img_s}, wrote {written}")
    report["classify"]["cli"] = {"seconds": seconds, "losses": losses,
                                 "evals": evals, "img_s": img_s}


def check_cls_detector(work, cfg_cls, build_model, nms_cuda, csp_cuda,
                       report):
    """14d: model_best.pth through MODEL.BACKBONE_PRETRAINED into the
    full-width detector (the Trainer's strict load), its backbone equal to
    the checkpoint's; one Predictor batch of two 608 images, finite rows,
    K1's and K2's launches counted. Returns them."""
    from yolov4_tpu_torch.engine.predictor import Predictor
    from yolov4_tpu_torch.utils.checkpoint import load_pretrained_backbone
    from yolov4_tpu_torch.utils.convert import load_weights
    cfg = cfg_cls.from_dict({"MODEL": {
        "BACKBONE_PRETRAINED": str(work / "out" / "model_best.pth")}})
    model = build_model(cfg, device="cuda", train=True)
    load_pretrained_backbone(model, cfg["MODEL"]["BACKBONE_PRETRAINED"])
    best = load_weights(cfg["MODEL"]["BACKBONE_PRETRAINED"])
    unequal = [k for k, v in model.backbone.state_dict().items()
               if not torch.equal(v.cpu(), best["backbone." + k])]
    if unequal:
        raise AssertionError(f"backbone differs from the classifier's: "
                             f"{unequal[:5]}")
    pred = Predictor(cfg, state_dict=model.state_dict(), batch_size=2,
                     device="cuda")
    images = np.random.default_rng(4).integers(0, 256, (2, 608, 608, 3),
                                               np.uint8)
    nms_cuda.greedy_nms_mask_cuda.launches = 0
    csp_cuda.fused_csp_stage_cuda.launches = 0
    det, valid = pred(images)
    k1 = nms_cuda.greedy_nms_mask_cuda.launches
    k2 = csp_cuda.fused_csp_stage_cuda.launches
    if det.shape != (2, 100, 7) or not np.isfinite(det).all() or k1 != 1:
        raise AssertionError(f"detector with the classifier's backbone: "
                             f"{det.shape}, finite {np.isfinite(det).all()}"
                             f", K1 {k1}")
    log(f"[classify] model_best.pth as BACKBONE_PRETRAINED: "
        f"{len(model.backbone.state_dict())} backbone tensors equal; one "
        f"608/b2 Predictor batch: {int(valid.sum())} detections, K1 {k1}, "
        f"K2 {k2}")
    del model, pred
    torch.cuda.empty_cache()
    report["classify"]["detector"] = {"detections": int(valid.sum()),
                                      "k1": k1, "k2": k2}
    return k1, k2


def phase_classify(cfg_cls, build_model, nms_cuda, csp_cuda, smi, report):
    """Phase 14: (a) and (c) in this process; then (b)'s two ranks beside
    (d)'s CLI training run, then (d)'s ``-e`` run and detector checks.
    K1's and K2's counts are set to 0 just before the classifier path and
    read just after it: in this process, in each rank and in each CLI
    process. Returns {run: (K1, K2)}, the detector batch apart."""
    import os
    t0 = time.time()
    report["classify"] = {}
    work = ROOT / "runs" / "chip_smoke_classify"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    nms_cuda.greedy_nms_mask_cuda.launches = 0
    csp_cuda.fused_csp_stage_cuda.launches = 0
    phase_cls_f64(report)
    phase_cls_timed(report, smi)
    launches = {"in_process": (nms_cuda.greedy_nms_mask_cuda.launches,
                               csp_cuda.fused_csp_stage_cuda.launches)}

    write_imagefolder(work / "imagenet")
    tasks = [("cls_sync", {})]
    deadline = time.monotonic() + CLS_LIMIT_S
    cli = start_cls_cli(work, [
        str(work / "imagenet"), "-b", "16", "--epochs", "2", "--num-classes",
        str(CLS_CLASSES), "--lr", "0.8", "--print-freq", "1", "--output-dir",
        str(work / "out")], "train")
    try:
        ranks = join_ranks(start_ranks(tasks, work), tasks, work, deadline)
    finally:
        text, launches["cli"], seconds = finish_cls_cli(work, cli, "train",
                                                        deadline)
    launches["sync_bn"] = tuple(map(sum, zip(*check_cls_sync(
        ranks["cls_sync"], report))))
    check_cls_cli(work, text, seconds, report)

    best = json.loads((work / "out" / "model_best.pth.meta.json").read_text())
    cli = start_cls_cli(work, [
        str(work / "imagenet"), "-e", "--resume",
        str(work / "out" / "model_best.pth"), "-b", "16", "--num-classes",
        str(CLS_CLASSES), "--output-dir", str(work / "eval")], "eval")
    text, launches["cli_eval"], seconds = finish_cls_cli(
        work, cli, "eval", time.monotonic() + CLS_LIMIT_S)
    got = [line.split("Prec@1 ")[1].split()[0] for line in text.splitlines()
           if "Prec@1" in line]
    if got != [f"{best['prec1']:.3f}"]:
        raise AssertionError(f"-e --resume model_best.pth gave Prec@1 {got},"
                             f" the best epoch {best['prec1']:.3f}")
    log(f"[classify] -e --resume model_best.pth: Prec@1 {got[0]} = the best "
        f"epoch's ({best['epoch'] + 1}); {seconds:.1f}s")
    report["classify"]["eval_prec1"] = float(got[0])

    bad = {run: n for run, n in launches.items() if n != (0, 0)}
    if bad:
        raise AssertionError(f"K1/K2 launched on the classifier path: {bad}")
    report["classify"]["launches"] = launches
    detector = check_cls_detector(work, cfg_cls, build_model, nms_cuda,
                                  csp_cuda, report)
    shutil.rmtree(work, ignore_errors=True)
    report["classify"]["seconds"] = time.time() - t0
    log(f"[classify] K1/K2 on the classifier path {launches}; phase 14 in "
        f"{report['classify']['seconds']:.1f}s")
    return detector


# --------------------------------------------------------------------------
# Phase 19 (resume): a JAX package checkpoint resumed through ``python -m
# yolov4_tpu_torch.train --resume`` and ``darknet_pretrain --resume``. The
# card's machine has no JAX, so the phase writes the JAX package's .ckpt
# layout itself (write_jax_ckpt, held against flax and the JAX Trainer by
# tests/test_torch_resume_jax.py).

RESUME_EMA_DECAY = 0.99     # the EMA differs from the parameters at once
RESUME_AT = 3               # CHECKPOINT_EVERY_STEPS: inside a window of 2
RESUME_TRAIN_IMAGES, RESUME_VAL_IMAGES = 48, 8    # 6 steps of b8, 1 batch
RESUME_CLS_TRAIN, RESUME_CLS_VAL = 12, 2          # a class: 6 steps of b8

# flax's msgpack encoding (flax.serialization.msgpack_serialize): maps,
# str, bin, ints, floats, nil, bools; ext 1 an ndarray, ext 3 a numpy
# scalar, each the msgpack of (shape, dtype name, C bytes). Flax chunks an
# array above 2**30 bytes; no array of the port's trainers is that large.
_MP_STR = ((0xd9, ">B", 1 << 8), (0xda, ">H", 1 << 16), (0xdb, ">I", 1 << 32))
_MP_BIN = ((0xc4, ">B", 1 << 8), (0xc5, ">H", 1 << 16), (0xc6, ">I", 1 << 32))
_MP_ARRAY = ((0xdc, ">H", 1 << 16), (0xdd, ">I", 1 << 32))
_MP_MAP = ((0xde, ">H", 1 << 16), (0xdf, ">I", 1 << 32))
_MP_EXT = ((0xc7, ">B", 1 << 8), (0xc8, ">H", 1 << 16), (0xc9, ">I", 1 << 32))
_MP_FIXEXT = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
_MP_INT = ((0xcc, ">B", 0, 1 << 8), (0xcd, ">H", 0, 1 << 16),
           (0xce, ">I", 0, 1 << 32), (0xcf, ">Q", 0, 1 << 64),
           (0xd0, ">b", -(1 << 7), 1 << 7), (0xd1, ">h", -(1 << 15), 1 << 15),
           (0xd2, ">i", -(1 << 31), 1 << 31),
           (0xd3, ">q", -(1 << 63), 1 << 63))


def _mp_header(n, fix, fix_max, forms):
    """The header of a value of length ``n``: ``fix | n`` up to
    ``fix_max``, else the first length form that holds ``n``."""
    if fix is not None and n <= fix_max:
        return bytes([fix | n])
    for code, fmt, limit in forms:
        if n < limit:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack length {n} too large")


def _mp_int(v):
    if 0 <= v < 128:
        return bytes([v])
    if -32 <= v < 0:
        return struct.pack(">b", v)
    for code, fmt, lo, hi in _MP_INT:
        if lo <= v < hi:
            return bytes([code]) + struct.pack(fmt, v)
    raise ValueError(f"msgpack int {v} out of range")


def _mp_ext(code, arr, out):
    """flax's ``_ndarray_to_bytes`` inside an ext value; the array's bytes
    are appended as a view, not copied."""
    if arr.nbytes > 1 << 30:
        raise ValueError(f"an array of {arr.nbytes} bytes: flax would chunk "
                         "it, this writer does not")
    if not arr.flags.c_contiguous:
        arr = arr.copy(order="C")
    head = [b"\x93"]
    _mp_pack(tuple(int(d) for d in arr.shape), head)
    _mp_pack(arr.dtype.name, head)
    head.append(_mp_header(arr.nbytes, None, 0, _MP_BIN))
    head = b"".join(head)
    n = len(head) + arr.nbytes
    if n in _MP_FIXEXT:
        out.append(bytes([_MP_FIXEXT[n]]) + struct.pack(">b", code))
    else:
        out.append(_mp_header(n, None, 0, _MP_EXT) + struct.pack(">b", code))
    out += [head, memoryview(arr.reshape(-1).view(np.uint8))]


def _mp_pack(obj, out):
    kind = type(obj)
    if obj is None:
        out.append(b"\xc0")
    elif kind is bool:
        out.append(b"\xc3" if obj else b"\xc2")
    elif kind is int:
        out.append(_mp_int(obj))
    elif kind is float:
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif kind is str:
        data = obj.encode("utf-8")
        out += [_mp_header(len(data), 0xa0, 31, _MP_STR), data]
    elif kind is bytes:
        out += [_mp_header(len(obj), None, 0, _MP_BIN), obj]
    elif kind in (list, tuple):
        out.append(_mp_header(len(obj), 0x90, 15, _MP_ARRAY))
        for value in obj:
            _mp_pack(value, out)
    elif kind is dict:
        out.append(_mp_header(len(obj), 0x80, 15, _MP_MAP))
        for key, value in obj.items():
            _mp_pack(key, out)
            _mp_pack(value, out)
    elif isinstance(obj, np.ndarray):
        _mp_ext(1, obj, out)
    elif isinstance(obj, np.generic):
        _mp_ext(3, np.asarray(obj), out)
    else:
        raise TypeError(f"no msgpack encoding for {kind.__name__}")


def write_jax_ckpt(path, tree):
    """Write the nested dict ``tree`` (str keys; numpy arrays and scalars,
    Python scalars, None) as the JAX package's ``save_checkpoint`` writes a
    bundle: flax's msgpack, to a temporary name and then renamed."""
    import os
    pieces = []
    _mp_pack(tree, pieces)
    tmp = str(path) + ".tmp"
    with open(tmp, "wb") as f:
        for piece in pieces:
            f.write(piece)
    os.replace(tmp, path)


def jax_tree_path(key, ndim):
    """The JAX package's (collection, path) of the port's state-dict entry
    ``key`` of ``ndim`` dimensions, the inverse of utils/convert.
    flax_path_to_torch_key; None for ``num_batches_tracked`` (flax keeps no
    such counter)."""
    *modules, leaf = key.split(".")
    if leaf == "num_batches_tracked":
        return None
    names = []
    for seg in modules:   # Sequential indices rejoin their module's name
        if seg.isdigit() and names:
            names[-1] += "_" + seg
        else:
            names.append(seg)
    if leaf in ("running_mean", "running_var"):
        return "batch_stats", (*names, leaf[len("running_"):])
    if leaf == "weight":
        return "params", (*names, "kernel" if ndim > 1 else "scale")
    if leaf == "bias":
        return "params", (*names, "bias")
    raise ValueError(f"{key}: no JAX leaf")


def jax_tree(named):
    """{state-dict key: tensor} in the port's layout -> {collection: nested
    dict of numpy arrays} in the JAX package's (OIHW -> HWIO, a Dense
    kernel transposed); each path checked to map back to its key."""
    from yolov4_tpu_torch.utils.convert import flax_path_to_torch_key
    out = {}
    for key, value in named.items():
        where = jax_tree_path(key, value.dim())
        if where is None:
            continue
        coll, path = where
        if flax_path_to_torch_key(coll, path) != key:
            raise ValueError(f"{key}: {coll}/{'/'.join(path)} maps back to "
                             f"{flax_path_to_torch_key(coll, path)}")
        arr = value.detach().cpu().numpy()
        if path[-1] == "kernel":
            arr = arr.transpose((2, 3, 1, 0)) if arr.ndim == 4 else arr.T
        node = out.setdefault(coll, {})
        for name in path[:-1]:
            node = node.setdefault(name, {})
        node[path[-1]] = np.ascontiguousarray(arr)
    return out


def jax_bundle(port, order):
    """A port trainer's bundle (utils/checkpoint.py; its optimizer's state
    indexed by the parameter names ``order``) -> the tree the JAX
    package's trainers save: variables in the JAX layout, optax's
    ``opt_state`` (Adam ``{count, mu, nu}``; SGD ``{"0": {"inner_state":
    {}}, "1": {"trace"}}``), meta and, with an EMA, raw_params."""
    per = {name: port["opt_state"]["state"][i]
           for i, name in enumerate(order)}
    if all("exp_avg" in s for s in per.values()):
        steps = {float(s["step"]) for s in per.values()}
        if len(steps) != 1:
            raise ValueError(f"Adam's parameters at different steps {steps}")
        def moment(key):
            return jax_tree({n: s[key] for n, s in per.items()})["params"]

        opt_state = {"count": np.asarray(int(steps.pop()), np.int32),
                     "mu": moment("exp_avg"), "nu": moment("exp_avg_sq")}
    else:
        opt_state = {"0": {"inner_state": {}}, "1": {"trace": jax_tree(
            {n: s["momentum_buffer"] for n, s in per.items()})["params"]}}
    bundle = {"variables": jax_tree(port["variables"]),
              "opt_state": opt_state, "meta": dict(port["meta"])}
    if "raw_params" in port:
        bundle["raw_params"] = jax_tree(port["raw_params"])["params"]
    return bundle


class StopRun(Exception):
    """Ends run A once its mid-epoch checkpoint is kept."""


def run_until_checkpoint(trainer, pth, ckpt):
    """Run A: train epoch 0 up to the trainer's first mid-epoch checkpoint,
    keep it as ``pth`` and, in the JAX package's layout, as ``ckpt``, then
    stop. Returns the writer's seconds."""
    from yolov4_tpu_torch.utils.convert import (param_names_in_order,
                                                torch_load)
    save = trainer._save_mid_epoch
    seconds = []

    def saving(epoch, batch_index):
        save(epoch, batch_index)
        shutil.copyfile(Path(trainer.output_dir) / "checkpoint.pth", pth)
        t0 = time.time()
        write_jax_ckpt(ckpt, jax_bundle(torch_load(str(pth)),
                                        param_names_in_order(
                                            trainer.optimizer, trainer.model)))
        seconds.append(time.time() - t0)
        raise StopRun

    trainer._save_mid_epoch = saving
    try:
        trainer.train_epoch(0)
    except StopRun:
        return seconds[0]
    finally:
        trainer.close()
    raise AssertionError("run A ended without a mid-epoch checkpoint")


def resume_snapshot(trainer, counters):
    """A resumed trainer's loaded state on the CPU: model state (parameters
    and buffers), EMA, each optimizer state tensor, the counters."""
    state = trainer.optimizer.state_dict()["state"]
    ema = trainer.state.ema_params or {}
    return {"model": {k: v.detach().cpu().clone()
                      for k, v in trainer.model.state_dict().items()},
            "ema": {k: v.cpu().clone() for k, v in ema.items()},
            "opt": {f"{i}.{k}": v.detach().cpu().clone()
                    for i, s in state.items() for k, v in s.items()},
            "counters": {c: getattr(trainer, c, None) for c in counters}
            | {"step": trainer.state.step}}


@contextmanager
def probing(module, name, counters, runs):
    """``module.<name>`` (a trainer class) replaced for the block by a
    subclass that times its ``_resume``, then, once built, appends to
    ``runs`` a dict holding the trainer, its resume_snapshot and the list
    its train_step fills with each micro-step's loss (a device scalar)."""
    base = getattr(module, name)

    class Probe(base):
        def _resume(self, path):
            t0 = time.time()
            super()._resume(path)
            self.resume_seconds = time.time() - t0

        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            run = {"trainer": self, "losses": [],
                   "seconds": self.resume_seconds,
                   "loaded": resume_snapshot(self, counters)}
            step = self.train_step

            def recording(state, *batch):
                state = step(state, *batch)
                run["losses"].append(state.loss)
                return state

            self.train_step = recording
            runs.append(run)

    setattr(module, name, Probe)
    try:
        yield
    finally:
        setattr(module, name, base)


def differing(a, b, skip=()):
    """Entries of two {name: tensor} dicts that are not equal bit for bit
    (or lie in only one), and the largest |a - b| over the shared ones."""
    names = [k for k in sorted(set(a) | set(b))
             if not k.endswith(skip)]
    bad = [k for k in names if k not in a or k not in b
           or not torch.equal(a[k], b[k])]
    gap = max((float((a[k].double() - b[k].double()).abs().max())
               for k in bad if k in a and k in b and a[k].numel()),
              default=0.0)
    return bad, gap


def check_resumed(label, b, c, report):
    """(c) B's loaded state against C's, bit for bit; (d) the continuation:
    each micro-step's loss and the final model state. ``num_batches_tracked``
    is left out: the JAX layout has no such counter (B's reads 0) and the
    port's BatchNorm, whose momentum is fixed, never reads it."""
    skip = ("num_batches_tracked",)
    out = {}
    for part in ("model", "ema", "opt"):
        bad, gap = differing(b["loaded"][part], c["loaded"][part], skip)
        if bad:
            raise AssertionError(f"{label}: the loaded {part} differs between "
                                 f"the .ckpt and the .pth resume in "
                                 f"{len(bad)} tensors (e.g. {bad[:3]}, max "
                                 f"|d| {gap})")
        out[f"loaded_{part}_tensors"] = len(b["loaded"][part])
    if b["loaded"]["counters"] != c["loaded"]["counters"]:
        raise AssertionError(f"{label}: counters {b['loaded']['counters']} "
                             f"from the .ckpt, {c['loaded']['counters']} "
                             "from the .pth")
    losses_b = [float(v) for v in b["losses"]]
    losses_c = [float(v) for v in c["losses"]]
    final = [{k: v.detach().cpu() for k, v in
              r["trainer"].model.state_dict().items()} for r in (b, c)]
    bad, gap = differing(*final, skip)
    loss_gap = max((abs(x - y) for x, y in zip(losses_b, losses_c)),
                   default=0.0)
    out.update(counters=b["loaded"]["counters"], losses_ckpt=losses_b,
               losses_pth=losses_c, loss_max_abs_gap=loss_gap,
               final_tensors_differing=len(bad), final_max_abs_gap=gap,
               resume_s_ckpt=b["seconds"], resume_s_pth=c["seconds"])
    report["resume"][label] = out
    if (len(losses_b) != len(losses_c) or not losses_b
            or not np.isfinite(losses_b).all() or loss_gap or bad):
        raise AssertionError(
            f"{label}: the continuation differs: losses {losses_b} from the "
            f".ckpt, {losses_c} from the .pth; {len(bad)} final tensors "
            f"differ (max |d| {gap}, e.g. {bad[:3]})")
    return out


def resume_detector(work, coco_ids, nms_cuda, csp_cuda, report):
    """(a)-(d), (f), (g) for the detector: run A writes a mid-epoch
    checkpoint at batch RESUME_AT, turned into the JAX layout; B resumes
    that .ckpt and C the .pth, each through ``train.main --deterministic``
    (cuDNN's deterministic kernels, the base seeds pinned). The loaders
    run in this process without mosaic: the resume, not the augmentation
    (phase 10's), is under test here."""
    import yaml
    from yolov4_tpu_torch import train as train_cli
    from yolov4_tpu_torch.config import Config
    from yolov4_tpu_torch.engine import trainer as trainer_mod
    write_val2017(work, coco_ids, RESUME_TRAIN_IMAGES, name="train2017",
                  seed=8)
    write_val2017(work, coco_ids, RESUME_VAL_IMAGES, name="val2017", seed=9)

    def config(name, every=0):
        return {"DATA": {"BATCH_SIZE": 8, "WORKERS": 0},
                "MODEL": {"PALLAS_CSP": True},
                "AUGMENTATION": {"IS_MOSAIC": False},
                "TEST": {"BATCH_SIZE": 8},
                "TRAIN": {"ACCUMULATION_STEPS": 2,
                          "CHECKPOINT_EVERY_STEPS": every,
                          "EMA_DECAY": RESUME_EMA_DECAY, "MAX_EPOCHS": 1,
                          "OUTPUT_DIR": str(work / name)}}

    pth, ckpt = work / "mid.pth", work / "mid.ckpt"
    write_s = run_until_checkpoint(trainer_mod.Trainer(
        Config.from_dict(config("a", RESUME_AT)), str(work), device="cuda"),
        pth, ckpt)
    torch.cuda.empty_cache()

    runs, launches = [], []
    counters = ("start_epoch", "_resume_skip", "best_ap50", "best_ap50_95")
    for name, path in (("b", ckpt), ("c", pth)):
        with open(work / f"{name}.yaml", "w") as f:
            yaml.safe_dump(config(name), f)
        nms_cuda.greedy_nms_mask_cuda.launches = 0
        csp_cuda.fused_csp_stage_cuda.launches = 0
        with probing(trainer_mod, "Trainer", counters, runs):
            train_cli.main([str(work), "-c", str(work / f"{name}.yaml"),
                            "--resume", str(path), "--deterministic",
                            "--print-freq", "1", "--device", "cuda"])
        launches.append(k_counts(nms_cuda, csp_cuda))
    want = {"start_epoch": 0, "_resume_skip": RESUME_AT, "step": RESUME_AT}
    got = {k: runs[0]["loaded"]["counters"][k] for k in want}
    if got != want:
        raise AssertionError(f"detector: resumed at {got}, expected {want}")
    out = check_resumed("detector", runs[0], runs[1], report)
    if launches[0] != (1, 3):
        raise AssertionError(f"detector: B's validation launched K1 "
                             f"{launches[0][0]}, K2 {launches[0][1]} times "
                             "(a batch: 1 and 3 expected)")
    out.update(ckpt_mb=ckpt.stat().st_size / 1e6, pth_mb=pth.stat().st_size
               / 1e6, write_s=write_s, launches_ckpt=launches[0],
               launches_pth=launches[1],
               params=sum(p.numel() for p in
                          runs[0]["trainer"].model.parameters()))
    for run in runs:   # the trainers and snapshots: ~2 GB of host memory
        run.clear()
    return out, launches


def resume_classifier(work, report):
    """(e): the same for ClassifierTrainer at full width, crop 256, b8,
    through ``darknet_pretrain.main``, under cuDNN's deterministic
    kernels, the loaders in this process."""
    from yolov4_tpu_torch import darknet_pretrain
    from yolov4_tpu_torch.classify import trainer as cls_mod
    root = work / "imagenet"
    write_imagefolder(root, n_train=RESUME_CLS_TRAIN, n_val=RESUME_CLS_VAL)
    common = dict(batch_size=8, epochs=1, workers=0, num_classes=CLS_CLASSES)
    pth, ckpt = work / "cls_mid.pth", work / "cls_mid.ckpt"
    write_s = run_until_checkpoint(cls_mod.ClassifierTrainer(
        str(root), output_dir=str(work / "cls_a"),
        checkpoint_every_steps=RESUME_AT, device="cuda", **common), pth, ckpt)
    torch.cuda.empty_cache()
    runs = []
    for name, path in (("cls_b", ckpt), ("cls_c", pth)):
        with probing(cls_mod, "ClassifierTrainer",
                     ("start_epoch", "_resume_skip", "best_prec1"), runs):
            darknet_pretrain.main([
                str(root), "-b", "8", "--epochs", "1", "-j", "0",
                "--num-classes", str(CLS_CLASSES), "--print-freq", "1",
                "--output-dir", str(work / name), "--resume", str(path),
                "--device", "cuda"])
    got = {k: runs[0]["loaded"]["counters"][k]
           for k in ("start_epoch", "_resume_skip", "step")}
    if got != {"start_epoch": 0, "_resume_skip": RESUME_AT,
               "step": RESUME_AT}:
        raise AssertionError(f"classifier: resumed at {got}")
    out = check_resumed("classifier", runs[0], runs[1], report)
    out.update(ckpt_mb=ckpt.stat().st_size / 1e6,
               pth_mb=pth.stat().st_size / 1e6, write_s=write_s)
    for run in runs:   # the trainers and snapshots
        run.clear()
    return out


def phase_resume(coco_ids, nms_cuda, csp_cuda, smi, report):
    """Phase 19. K1's and K2's counts are set to 0 just before each resumed
    detector run and read just after; returns the sums over B and C."""
    from yolov4_tpu_torch.utils.logging import setup_logging
    t0 = time.time()
    work = ROOT / "runs" / "chip_smoke_resume"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    report["resume"] = {}
    cudnn = torch.backends.cudnn
    flags = (cudnn.deterministic, cudnn.benchmark)
    try:
        det, launches = resume_detector(work, coco_ids, nms_cuda, csp_cuda,
                                        report)
        cudnn.deterministic, cudnn.benchmark = True, False
        cls = resume_classifier(work, report)
    finally:
        cudnn.deterministic, cudnn.benchmark = flags
        # the CLIs pointed the log at files under ``work``
        setup_logging()
    shutil.rmtree(work, ignore_errors=True)
    seconds = time.time() - t0
    report["resume"]["seconds"] = seconds
    log(f"[resume] detector, full width ({det['params']} parameters), 608/b8 "
        f"bf16 Adam, ACCUMULATION_STEPS 2, EMA {RESUME_EMA_DECAY}, a "
        f"mid-epoch checkpoint at batch {RESUME_AT} ({smi}): the JAX .ckpt "
        f"{det['ckpt_mb']:.1f} MB written in {det['write_s']:.2f}s, resumed "
        f"in {det['resume_s_ckpt']:.2f}s (the port's .pth, "
        f"{det['pth_mb']:.1f} MB, in {det['resume_s_pth']:.2f}s); loaded "
        f"state bit-equal ({det['loaded_model_tensors']} model, "
        f"{det['loaded_ema_tensors']} EMA, {det['loaded_opt_tensors']} "
        f"optimizer tensors; counters {det['counters']}); the "
        f"{len(det['losses_ckpt'])} losses after the resume "
        f"{det['losses_ckpt']} and the final state bit-equal; K1, K2 in "
        f"the validations {launches}")
    log(f"[resume] classifier, full width, crop 256, b8 bf16 Adam: the JAX "
        f".ckpt {cls['ckpt_mb']:.1f} MB written in {cls['write_s']:.2f}s, "
        f"resumed in {cls['resume_s_ckpt']:.2f}s (.pth "
        f"{cls['resume_s_pth']:.2f}s); loaded state bit-equal; the "
        f"{len(cls['losses_ckpt'])} losses after the resume "
        f"{cls['losses_ckpt']} and the final state bit-equal")
    log(f"[resume] {smi}: phase 19 in {seconds:.1f}s")
    return tuple(map(sum, zip(*launches)))


# Phase 16 (learning): the gates. (a) the overfit tool's own assertion;
# (b) a port that does not learn scores near 0 held-out, the JAX package
# 0.80, so 0.5 leaves room for seed spread; (c) int8 against bf16 on the
# same weights (JAX: at most 0.0023 AP); (d) PALLAS_CSP against the default
# path on the same weights: both round to bfloat16 at different points and
# one flipped detection of 32 images moves AP50 by about 0.01.
LEARN_OVERFIT_AP50 = 0.9
LEARN_HELDOUT_AP50 = 0.5
LEARN_INT8_DAP50 = 0.05
LEARN_CSP_DAP50 = 0.02
LEARN_BUDGET_S = 360          # phase 16's time; (b)'s epochs are cut to fit
COCOEVAL_GATE_S = 60.0        # the JAX package's host-time gate, 5000 images


def k_counts(nms_cuda, csp_cuda):
    return (nms_cuda.greedy_nms_mask_cuda.launches,
            csp_cuda.fused_csp_stage_cuda.launches)


@contextmanager
def captured_stdout():
    """stdout collected into a list's one string, then echoed."""
    import contextlib
    import io
    buf, out = io.StringIO(), []
    try:
        with contextlib.redirect_stdout(buf):
            yield out
    finally:
        out.append(buf.getvalue())
        sys.stdout.write(out[0])
        sys.stdout.flush()


def learn_overfit(work, smi, report):
    """(a) tools.overfit_smoke.run at its defaults."""
    from yolov4_tpu_torch.tools import overfit_smoke
    args = overfit_smoke.parse_args(["--root", str(work / "overfit")])
    r = overfit_smoke.run(overfit_smoke.build_cfg(args), args)
    losses = ", ".join(f"{s}: {v:.1f}" for s, v in r["losses"])
    log(f"[learning] (a) overfit, full width 320/b8 bf16, {r['steps']} "
        f"steps ({smi}): loss {losses}; final {r['final_loss']:.1f}; "
        f"train-set AP {r['ap']:.4f} AP50 {r['ap50']:.4f}; step "
        f"{r['step_ms']:.2f} ms; {r['seconds']:.1f}s; launches "
        f"{r['launches']}")
    report["learning"]["overfit"] = {k: r[k] for k in (
        "losses", "final_loss", "ap", "ap50", "steps", "step_ms",
        "train_seconds", "seconds", "launches")}
    if not r["ap50"] > LEARN_OVERFIT_AP50:
        raise AssertionError(f"overfit: train-set AP50 {r['ap50']} <= "
                             f"{LEARN_OVERFIT_AP50}")
    if r["launches"]["greedy_nms_mask"] < 1:
        raise AssertionError("overfit: K1 never launched in its scoring")
    return r


def epoch_s(gen, cfg, args):
    """The seconds of one epoch of (b)'s manual loop, its loader included,
    on a model built for the purpose, after one step that warms it up."""
    from yolov4_tpu_torch.tools.overfit_smoke import build_train, to_device
    gen.prepare_dataset(args)
    device = torch.device("cuda")
    loader = gen.train_loader(cfg, args)
    _, step, state = build_train(cfg, device, len_epoch=len(loader))
    imgs, target = next(iter(loader))
    state = step(state, *to_device(imgs, target["padded_labels"], device))
    torch.cuda.synchronize()
    t0 = time.time()
    for imgs, target in loader:
        state = step(state, *to_device(imgs, target["padded_labels"], device))
    torch.cuda.synchronize()
    return time.time() - t0


def learn_generalize(work, t_phase, smi, report):
    """(b) tools.generalization_smoke.run in its manual loop at its
    defaults, the epochs cut (never the width or the size) when its
    training, at the rate of an epoch timed before it, would carry phase
    16 past LEARN_BUDGET_S."""
    from yolov4_tpu_torch.tools import generalization_smoke as gen
    args = gen.build_parser().parse_args(["--root", str(work / "shapes")])
    one = epoch_s(gen, gen.build_cfg(args), args)
    left = LEARN_BUDGET_S - (time.time() - t_phase)
    fits = int(left // one)
    log(f"[learning] (b) an epoch took {one:.2f}s; {args.epochs} epochs "
        f"would take {args.epochs * one:.0f}s of the {left:.0f}s left of "
        f"phase 16's {LEARN_BUDGET_S}s")
    if fits < args.epochs:
        log(f"[learning] (b) running {max(fits, 1)} epochs to fit")
        args.epochs = max(fits, 1)
    cfg = gen.build_cfg(args)
    r = gen.run(cfg, args)
    log(f"[learning] (b) generalization, full width 320/b8 bf16, "
        f"{args.train_images} train / {args.val_images} held-out shapes, "
        f"{args.epochs} epochs, {r['steps']} steps ({smi}): held-out AP "
        f"{r['ap']:.4f} AP50 {r['ap50']:.4f}; train split AP "
        f"{r['train_ap']:.4f} AP50 {r['train_ap50']:.4f}; step "
        f"{r['step_ms']:.2f} ms; {r['seconds']:.1f}s; launches "
        f"{r['launches']}")
    report["learning"]["generalization"] = dict(
        {k: r[k] for k in ("losses", "ap", "ap50", "train_ap", "train_ap50",
                           "steps", "step_ms", "train_seconds", "seconds",
                           "launches")}, epochs=args.epochs,
        epoch_s=one)
    if not r["ap50"] >= LEARN_HELDOUT_AP50:
        raise AssertionError(f"generalization: held-out AP50 {r['ap50']} < "
                             f"{LEARN_HELDOUT_AP50}")
    return cfg, args, r


def learn_quant(cfg, args, weights, smi, report):
    """(c) quant_ab on (b)'s weights."""
    from yolov4_tpu_torch.tools import generalization_smoke as gen
    t0 = time.time()
    q = gen.quant_ab(cfg, weights, args.root, args.img_size,
                     args.batch_size, "cuda")
    seconds = time.time() - t0
    deltas = "; ".join(f"{name} dAP {v['delta_ap']:+.4f} dAP50 "
                       f"{v['delta_ap50']:+.4f}" for name, v in q.items()
                       if name != "bf16")
    log(f"[learning] (c) quant_ab on (b)'s raw weights, held-out ({smi}): "
        f"bf16 AP {q['bf16']['ap']:.4f} AP50 {q['bf16']['ap50']:.4f}; "
        f"{deltas} (JAX package: int8 costs <= 0.0023 AP); {seconds:.1f}s")
    report["learning"]["quant"] = dict(q, seconds=seconds)
    bad = {name: v["delta_ap50"] for name, v in q.items()
           if name.startswith("int8")
           and not abs(v["delta_ap50"]) <= LEARN_INT8_DAP50}
    if bad:
        raise AssertionError(f"quant_ab: |dAP50| > {LEARN_INT8_DAP50}: {bad}")
    if q["approx_topk"]["delta_ap"] != 0 or q["approx_topk"]["delta_ap50"] != 0:
        raise AssertionError(f"quant_ab: approx_topk moved AP: "
                             f"{q['approx_topk']}")
    return q["bf16"]


@contextmanager
def captured_kernel_inputs(stages, cands):
    """Inside the block every K2 launch of the model's layers and every K1
    launch of the postprocess, from any thread, first appends its inputs
    (cloned) and the thread's name to ``stages`` or ``cands``."""
    from yolov4_tpu_torch.models import layers
    from yolov4_tpu_torch.ops import postprocess
    k2, k1 = layers.fused_csp_stage_cuda, postprocess.greedy_nms_mask_cuda

    def capture_k2(x, folded, nb, packed):
        stages.append((threading.current_thread().name, x.clone(), folded,
                       nb, packed))
        return k2(x, folded, nb, packed)

    def capture_k1(boxes, valid, t):
        cands.append((threading.current_thread().name, boxes.clone(),
                      valid.clone(), t))
        return k1(boxes, valid, t)

    layers.fused_csp_stage_cuda = capture_k2
    postprocess.greedy_nms_mask_cuda = capture_k1
    try:
        yield
    finally:
        layers.fused_csp_stage_cuda, postprocess.greedy_nms_mask_cuda = k2, k1


def kernel_inputs(run, nms_cuda, csp_cuda, label, n_k2, n_k1):
    """K2 on each stage input and K1 on each candidate set that ``run()``
    gives them (one batch of a Predictor), against their plain versions:
    K2 in float32 and bfloat16 within K2_TOL_*, K1's keep mask equal.
    ``run()`` must launch K2 ``n_k2`` and K1 ``n_k1`` times. These launches
    are comparisons, so the launch counts are put back as they were.
    Returns {"k2": rows, "k1": rows}; a K2 row's ``stage`` is its place in
    its thread's forward."""
    from yolov4_tpu_torch.ops.csp import fused_csp_stage_plain
    from yolov4_tpu_torch.ops.nms import greedy_nms_mask
    counts = k_counts(nms_cuda, csp_cuda)
    stages, cands = [], []
    with captured_kernel_inputs(stages, cands):
        run()
    torch.cuda.synchronize()
    if (len(stages) != n_k2 or len(cands) != n_k1
            or not all(bool(c[2].any()) for c in cands)):
        raise AssertionError(f"{label}: one batch gave K2 {len(stages)} and "
                             f"K1 {len(cands)} inputs (want {n_k2}, {n_k1}), "
                             f"{[int(c[2].sum()) for c in cands]} candidates")
    rows, k1_rows, seen = [], [], {}
    with tf32_off(), torch.inference_mode():
        for who, x, folded, nb, packed in stages:
            seen[who] = seen.get(who, 0) + 1
            name = f"stage{seen[who]}"
            for dt in (torch.float32, torch.bfloat16):
                with torch.cuda.device(x.device):
                    res = check_k2(csp_cuda, fused_csp_stage_plain, x.to(dt),
                                   folded, nb,
                                   packed if x.dtype == dt else None,
                                   f"{name} {label} {who} {str(dt)[6:]}")
                rows.append(dict(thread=who, stage=name, shape=list(x.shape),
                                 num_blocks=nb, dtype=str(dt)[6:], **res))
        for who, boxes, valid, t in cands:
            with torch.cuda.device(boxes.device):
                got = nms_cuda.greedy_nms_mask_cuda(boxes, valid, t)
                torch.cuda.synchronize()
            want = greedy_nms_mask(boxes, valid, t)
            if not torch.equal(got, want):
                raise AssertionError(
                    f"K1 on {label}'s candidates {tuple(boxes.shape)} "
                    f"({who}): keep masks differ at "
                    f"{int((got != want).sum())} positions")
            k1_rows.append(dict(thread=who, shape=list(boxes.shape), t=t,
                                valid=int(valid.sum()), kept=int(got.sum())))
    nms_cuda.greedy_nms_mask_cuda.launches = counts[0]
    csp_cuda.fused_csp_stage_cuda.launches = counts[1]
    log(f"[kernel inputs] {label}: K2 within its tolerances at "
        f"{[r['shape'] for r in rows[::2]]} in float32 and bfloat16 "
        f"(max_abs_err {max(r['max_abs_err'] for r in rows):.4g}); K1's keep "
        f"masks equal to the plain version's ({k1_rows})")
    return dict(k2=rows, k1=k1_rows)


def learn_kernel_inputs(cfg, args, weights, nms_cuda, csp_cuda, report):
    """K2 on each stage's input and K1 on the candidates that one held-out
    batch of ``cfg``'s Predictor gives them (320/b8, trained weights),
    against their plain versions (``kernel_inputs``)."""
    from yolov4_tpu_torch.engine.predictor import Predictor
    from yolov4_tpu_torch.tools.overfit_smoke import CONF, NMS, eval_loader
    imgs, _ = next(iter(eval_loader(cfg, args.root, "val2017",
                                    args.img_size, args.batch_size)))
    pred = Predictor(cfg, state_dict=weights, img_size=args.img_size,
                     batch_size=args.batch_size, conf_thre=CONF, nms_thre=NMS,
                     device="cuda")
    report["learning"]["kernel_inputs"] = kernel_inputs(
        lambda: pred(imgs), nms_cuda, csp_cuda,
        f"one held-out batch {args.img_size}/b{args.batch_size} trained",
        3, 1)


def learn_k2(cfg, args, weights, bf16, nms_cuda, csp_cuda, smi, report):
    """(d) the held-out split with PALLAS_CSP on against (c)'s bf16 score
    with it off: K2 on trained weights, 3 launches a forward; then K1 and
    K2 against their plain versions on the inputs this path gives them."""
    from yolov4_tpu_torch.tools.overfit_smoke import score
    import copy
    fused = copy.deepcopy(cfg)
    fused["MODEL"]["PALLAS_CSP"] = True
    before = k_counts(nms_cuda, csp_cuda)
    t0 = time.time()
    ap, ap50 = score(fused, weights, args.root, "val2017",
                     args.img_size, args.batch_size, "cuda")
    seconds = time.time() - t0
    k1, k2 = (a - b for a, b in zip(k_counts(nms_cuda, csp_cuda), before))
    batches = math.ceil(args.val_images / args.batch_size)
    log(f"[learning] (d) held-out with PALLAS_CSP on ({smi}): AP {ap:.4f} "
        f"AP50 {ap50:.4f} against {bf16['ap']:.4f} / {bf16['ap50']:.4f} off "
        f"(dAP50 {ap50 - bf16['ap50']:+.4f}); K1 {k1}, K2 {k2} launches in "
        f"{batches} batches; {seconds:.1f}s")
    report["learning"]["pallas_csp"] = dict(ap=ap, ap50=ap50, k1=k1, k2=k2,
                                            off_ap=bf16["ap"],
                                            off_ap50=bf16["ap50"],
                                            seconds=seconds)
    if k2 != 3 * batches or k1 != batches:
        raise AssertionError(f"PALLAS_CSP scoring: K1 {k1}, K2 {k2} in "
                             f"{batches} batches")
    if not abs(ap50 - bf16["ap50"]) <= LEARN_CSP_DAP50:
        raise AssertionError(f"PALLAS_CSP: |dAP50| {ap50 - bf16['ap50']} > "
                             f"{LEARN_CSP_DAP50}")
    learn_kernel_inputs(fused, args, weights, nms_cuda, csp_cuda, report)


def learn_trainer(work, smi, report):
    """(e) --use-trainer --recipe at 6 epochs on 32 / 8 images: the curve
    and 6 eval records; then both --resume refusals leave the root and its
    checkpoint on disk."""
    from yolov4_tpu_torch.tools import generalization_smoke as gen
    root = work / "recipe"
    argv = ["--use-trainer", "--recipe", "--epochs", "6", "--train-images",
            "32", "--val-images", "8", "--root", str(root)]
    with captured_stdout() as text:
        r = gen.main(argv)
    evals = [json.loads(line) for line in
             (Path(r["output_dir"]) / "metrics.jsonl").read_text()
             .splitlines()]
    evals = [e for e in evals if e.get("kind") == "eval"]
    if "held-out AP curve" not in text[0] or len(evals) != 6 \
            or len(r["recipe"]["curve"]) != 6:
        raise AssertionError(f"--recipe: {len(evals)} eval records, curve "
                             f"{r['recipe']['curve']}")
    ckpt = Path(r["output_dir"]) / "checkpoint.pth"
    stamp = (root / "dataset_params.json").read_text()
    refusals = {}
    for name, extra in (("without --use-trainer", []),
                        ("changed dataset flags",
                         ["--use-trainer", "--train-images", "16"])):
        try:
            gen.main(["--resume", str(ckpt), "--root", str(root),
                      "--val-images", "8", "--epochs", "6"]
                     + (["--train-images", "32"] if not extra else extra))
        except SystemExit as err:
            refusals[name] = err.code
        else:
            raise AssertionError(f"--resume {name} was not refused")
        if not (ckpt.is_file() and
                (root / "dataset_params.json").read_text() == stamp):
            raise AssertionError(f"--resume {name} removed the root or its "
                                 "checkpoint")
    if not all(code not in (0, None) for code in refusals.values()):
        raise AssertionError(f"--resume refusals exited {refusals}")
    log(f"[learning] (e) --use-trainer --recipe, 6 epochs, 32 / 8 images "
        f"({smi}): best held-out AP {r['ap']:.4f} AP50 {r['ap50']:.4f}, "
        f"{len(evals)} eval records, LR drop {r['recipe']['pre_ap50']} -> "
        f"{r['recipe']['post_ap50']}; {r['seconds']:.1f}s; --resume "
        f"refusals exit {refusals}, root and checkpoint kept")
    report["learning"]["trainer"] = dict(
        ap=r["ap"], ap50=r["ap50"], seconds=r["seconds"],
        launches=r["launches"], curve=r["recipe"]["curve"],
        refusals=refusals)
    return r


@contextmanager
def working_dir(path):
    import os
    old = os.getcwd()
    saved = {k: os.environ.pop(k) for k in ("COCO_ROOT", "YOLOV4_CKPT")
             if k in os.environ}
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(old)
        os.environ.update(saved)


def learn_export(work, cfg, args, gen_result, smi, report):
    """(f) export_torch on (b)'s weights, reloaded into a fresh Predictor
    (detections bit-equal to the live weights'); the gate with no data
    (exit 2, BLOCKED) and on (b)'s root with that .pth.tar (its AP equal
    to val.main's with the same arguments)."""
    from yolov4_tpu_torch import val as val_mod
    from yolov4_tpu_torch.engine.predictor import Predictor
    from yolov4_tpu_torch.tools import export_torch, run_coco_gate
    from yolov4_tpu_torch.tools.overfit_smoke import CONF, NMS, eval_loader
    from yolov4_tpu_torch.utils.checkpoint import save_checkpoint
    from yolov4_tpu_torch.utils.convert import load_weights
    meta = {"epoch": args.epochs - 1, "ap50": gen_result["ap50"],
            "ap50_95": gen_result["ap"], "best_ap50": gen_result["ap50"],
            "best_ap50_95": gen_result["ap"]}
    weights = {k: v.detach().cpu() for k, v in gen_result["weights"].items()}
    ckpt = save_checkpoint({"variables": weights, "meta": meta}, False,
                           output_dir=str(work), filename="shapes.pth")
    tar = str(work / "shapes.pth.tar")
    t0 = time.time()
    if export_torch.main([ckpt, tar]) != 0:
        raise AssertionError("export_torch failed")
    export_s = time.time() - t0
    imgs, _ = next(iter(eval_loader(cfg, args.root, "val2017",
                                    args.img_size, args.batch_size)))
    outs = [Predictor(cfg, state_dict=sd, img_size=args.img_size,
                      batch_size=args.batch_size, conf_thre=CONF,
                      nms_thre=NMS, device="cuda")(imgs)
            for sd in (weights, load_weights(tar))]
    if not all(np.array_equal(a, b) for a, b in zip(*outs)):
        raise AssertionError("the exported .pth.tar detects otherwise than "
                             "the live weights")
    empty = work / "gate_empty"
    empty.mkdir()
    with working_dir(empty), captured_stdout() as text:
        blocked = run_coco_gate.main(["--device", "cuda"])
    if blocked != 2 or "BLOCKED" not in text[0]:
        raise AssertionError(f"the gate without data exited {blocked}")
    gate_argv = ["--data", args.root, "--checkpoint", tar, "--device",
                 "cuda"]
    t0 = time.time()
    with captured_stdout() as text:
        gate_rc = run_coco_gate.main(gate_argv)
    gate_s = time.time() - t0
    line = [s for s in text[0].splitlines() if s.startswith("GATE: AP")]
    ap, ap50 = val_mod.main([
        args.root, "-c", run_coco_gate.DEFAULT_CFG, "--checkpoint", tar,
        "--conf-thre", "0.0001", "--nms-thre", "0.4", "--batch-size", "8",
        "--pre-nms-topk", "2048", "--max-dets", "1024", "--device", "cuda"])
    want = f"GATE: AP {ap:.5f} (published 0.35925) AP50 {ap50:.5f}"
    if gate_rc not in (0, 1) or len(line) != 1 or not line[0].startswith(want):
        raise AssertionError(f"the gate printed {line} (exit {gate_rc}); "
                             f"val.main gives AP {ap:.5f} AP50 {ap50:.5f}")
    log(f"[learning] (f) export_torch: {len(load_weights(tar))} tensors "
        f"(num_batches_tracked left out) in {export_s:.1f}s, its detections "
        f"bit-equal to the live weights'; gate without data: exit 2, "
        f"BLOCKED; gate on (b)'s root at the published protocol (608, conf "
        f"0.0001): {line[0]} (exit {gate_rc}) = val.main's; {gate_s:.1f}s "
        f"({smi})")
    report["learning"]["export_gate"] = dict(
        export_s=export_s, gate_exit_blocked=blocked, gate_exit=gate_rc,
        gate_ap=ap, gate_ap50=ap50, gate_s=gate_s)


def learn_cocoeval(smi, report):
    """(g) COCOeval on this host: the C matcher runs, the 5000-image set
    in under COCOEVAL_GATE_S, and at 500 images the stats of both
    matchers equal."""
    import contextlib
    from unittest import mock

    from yolov4_tpu_torch import native
    from yolov4_tpu_torch.data.synthetic import val2017_scale_case
    from yolov4_tpu_torch.eval.cocoeval import COCOEvaluator
    index, dts = val2017_scale_case(5000)
    ev = COCOEvaluator(index)
    t0 = time.time()
    ev.add_detections(dts)
    stats = ev.evaluate(verbose=False)
    seconds = time.time() - t0
    if ev.matcher != "c":
        raise AssertionError(f"COCOeval ran the {ev.matcher} matcher")
    if not seconds < COCOEVAL_GATE_S or not 0.0 < stats[0] < 1.0:
        raise AssertionError(f"COCOeval on 5000 images: {seconds:.1f}s, AP "
                             f"{stats[0]}")
    index, dts = val2017_scale_case(500)
    small = {}
    for no_c in (False, True):
        # the numpy matcher runs as on a host that cannot build the C one
        with mock.patch.object(native, "get_fastops", lambda: None) \
                if no_c else contextlib.nullcontext():
            ev = COCOEvaluator(index)
            t1 = time.time()
            ev.add_detections(dts)
            small[ev.matcher] = (ev.evaluate(verbose=False), time.time() - t1)
    if not np.array_equal(small["c"][0], small["numpy"][0]):
        raise AssertionError(f"COCOeval at 500 images: C {small['c'][0]} "
                             f"numpy {small['numpy'][0]}")
    log(f"[learning] (g) COCOeval, C matcher: 5000 images x 100 detections "
        f"in {seconds:.2f}s (gate {COCOEVAL_GATE_S:.0f}s), AP {stats[0]:.4f} "
        f"AP50 {stats[1]:.4f}; 500 images: C {small['c'][1]:.2f}s, numpy "
        f"{small['numpy'][1]:.2f}s, stats equal (the host of {smi})")
    report["learning"]["cocoeval"] = dict(
        seconds_5000=seconds, stats_5000=stats.tolist(),
        seconds_500_c=small["c"][1], seconds_500_numpy=small["numpy"][1])


def phase_learning(nms_cuda, csp_cuda, smi, report):
    """Phase 16; returns K1's and K2's launches in (a)-(f)."""
    t0 = time.time()
    report["learning"] = {}
    work = ROOT / "runs" / "chip_smoke_learning"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    nms_cuda.greedy_nms_mask_cuda.launches = 0
    csp_cuda.fused_csp_stage_cuda.launches = 0
    learn_overfit(work, smi, report)
    cfg, args, gen_result = learn_generalize(work, t0, smi, report)
    bf16 = learn_quant(cfg, args, gen_result["weights"], smi, report)
    learn_k2(cfg, args, gen_result["weights"], bf16, nms_cuda, csp_cuda,
             smi, report)
    learn_trainer(work, smi, report)
    learn_export(work, cfg, args, gen_result, smi, report)
    k1, k2 = k_counts(nms_cuda, csp_cuda)
    learn_cocoeval(smi, report)
    shutil.rmtree(work, ignore_errors=True)
    report["learning"].update(seconds=time.time() - t0, k1=k1, k2=k2)
    log(f"[learning] phase 16 in {time.time() - t0:.1f}s; K1 {k1}, K2 {k2} "
        "launches")
    if k1 < 1 or k2 < 1:
        raise AssertionError(f"phase 16: K1 {k1}, K2 {k2} launches")
    return k1, k2


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
    from yolov4_tpu_torch.ops import bn_act_cuda, csp_cuda, nms_cuda
    from yolov4_tpu_torch.ops import postprocess as postprocess_mod
    from yolov4_tpu_torch.ops.bn_act import batch_norm_act_plain
    from yolov4_tpu_torch.ops.csp import (fused_csp_stage_plain,
                                          kernel_widths, launch_plan)
    from yolov4_tpu_torch.ops.nms import greedy_nms_mask

    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    report = {}
    build_kernels([nms_cuda, csp_cuda, bn_act_cuda], report)
    k1_build_report(nms_cuda, report)
    k2_build_report(csp_cuda, kernel_widths, report)
    bn_act_build_report(bn_act_cuda, report)

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
    bn_sites = phase_bn_act(Config, build_model, Predictor, bn_act_cuda,
                            batch_norm_act_plain, report)
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
    int8_k1, int8_k2, int8_n, int8_products = phase_int8(
        Config, build_model, Predictor, val_mod, COCO_CLASS_IDS, nms_cuda,
        csp_cuda, smi, report)
    mesh_k1, mesh_k2, sd17, images17, mesh_rows = phase_mesh(
        Config, build_model, Predictor, nms_cuda, csp_cuda, smi, report)
    ranks_k1, ranks_k2 = phase_ranks(Config, Predictor, COCO_CLASS_IDS, sd17,
                                     images17, mesh_rows,
                                     (nms_cuda, csp_cuda), smi, report)
    del sd17, images17, mesh_rows
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
    # the classifier path launches neither kernel (checked inside); the
    # detector built on its backbone runs one Predictor batch
    cls_k1, cls_k2 = phase_classify(Config, build_model, nms_cuda, csp_cuda,
                                    smi, report)
    resume_k1, resume_k2 = phase_resume(COCO_CLASS_IDS, nms_cuda, csp_cuda,
                                        smi, report)
    learn_n1, learn_n2 = phase_learning(nms_cuda, csp_cuda, smi, report)
    kernels = {"kernels": [{
        "name": "greedy_nms_mask",
        "route": "cuda",
        "source": "yolov4_tpu_torch/csrc/nms.cu",
        "replaces": "yolov4_tpu/ops/nms_pallas.py:140",
        # the detection path's batches, the serving phase's (live runtime,
        # artifact runtime, video), the Trainer's validations (the three
        # Trainer runs and their resumes; of them, the runs with
        # AUGMENTATION.DEVICE), phase 12's data-parallel validations,
        # phase 14's detector batch on the classifier's backbone,
        # phase 15's int8 runs (Predictor, serving, val), phase 17's mesh
        # batches and mesh serving (one per replica per batch), phase 18's
        # ranks (a batch and a validation each) and NCCL batch, phase 19's
        # validations of the resumed runs (the JAX .ckpt's and the .pth's),
        # and phase 16's learning smokes, their scoring, the export check
        # and the gate
        "launches": (launches + serve_k1 + trainer_k1 + ddp_k1 + cls_k1
                     + int8_k1 + mesh_k1 + ranks_k1 + resume_k1 + learn_n1),
        "launches_in_resume": resume_k1,
        "launches_in_serving": serve_k1,
        "launches_in_mesh": mesh_k1,
        "launches_in_ranks": ranks_k1,
        "launches_in_learning": learn_n1,
        "launches_in_int8": int8_k1,
        "launches_in_serving_by_run": {k: v[0] for k, v in
                                       serve_launches.items()},
        "launches_in_trainer": trainer_k1,
        "launches_in_device_aug_trainer": device_k1,
        "launches_in_ddp": ddp_k1,
        "launches_in_classifier": 0,
        "launches_in_classifier_backbone_detector": cls_k1,
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
        # val's batches, the serving phase's, the Trainer's validations,
        # phase 12's and phase 15's (2 a forward under QUANT_SPAN late,
        # none under full; phase 14's detector batch runs without
        # PALLAS_CSP), phase 17's (3 a replica's forward), phase 18's (3 a
        # forward), phase 19's resumed runs' validations and phase 16's
        # PALLAS_CSP scoring of trained weights
        "launches": (k2_launches + serve_k2 + trainer_k2 + ddp_k2 + cls_k2
                     + int8_k2 + mesh_k2 + ranks_k2 + resume_k2 + learn_n2),
        "launches_in_resume": resume_k2,
        "launches_in_serving": serve_k2,
        "launches_in_mesh": mesh_k2,
        "launches_in_ranks": ranks_k2,
        "launches_in_learning": learn_n2,
        "launches_in_int8": int8_k2,
        "launches_per_int8_forward": {"late": 2, "full": 0},
        "launches_in_serving_by_run": {k: v[1] for k, v in
                                       serve_launches.items()},
        "launches_in_trainer": trainer_k2,
        "launches_in_device_aug_trainer": device_k2,
        "launches_in_ddp": ddp_k2,
        "launches_in_classifier": 0,
        "max_abs_err": max(r["max_abs_err"] for r in stages),
        # phase 16 (d): each stage's input of a held-out batch at 320/b8,
        # trained weights, float32 and bfloat16
        "max_abs_err_learning": max(
            r["max_abs_err"]
            for r in report["learning"]["kernel_inputs"]["k2"]),
        # phase 17: each replica's stage inputs of a mesh batch at 608/b16
        # and of the 416 serving bucket's (b8 shards), float32 and bfloat16
        "max_abs_err_mesh": max(
            r["max_abs_err"]
            for ki in ([row["kernel_inputs"] for row in report["mesh"]["rows"]]
                       + [report["mesh_serve"]["kernel_inputs"]])
            for r in ki["k2"]),
        "ms": sum(r["ms"] for r in stages),
        "device_ms": sum(r["device_ms"] for r in stages),
        "plain_ms": sum(r["plain_ms"] for r in stages),
        "bound_ms": sum(r["bound_ms"] for r in stages),
        "bound_by": "operations" if all(r["bound_by"] == "operations"
                                        for r in stages) else "bytes",
        "library_ms": None,
        "library_note": "no single PyTorch call computes a CSP stage body; "
                        "default_body_ms is the default path's body, "
                        "cuDNN's convolutions each followed by one "
                        "batch_norm_act pass (BN and Mish), "
                        "cudnn_convs_ms cuDNN's convolutions alone",
        "default_body_ms": sum(r["default_body_ms"] for r in stages),
        "conv_launches_per_forward": sum(r["conv_launches"] for r in stages),
        "cudnn_convs_ms": sum(r["cudnn_convs_ms"] for r in stages),
        "plan_bound_ms": sum(r["plan_bound_ms"] for r in stages),
        "per_stage": stages,
        "per_stage_416": [r for r in report["serve_k2_416"]
                          if r["dtype"] == "bfloat16"],
    }, {
        # one entry for the three sites of BN_ACT_SITES in a 608/b64
        # forward: times and bounds are their sums, per_site holds each
        "name": "batch_norm_act",
        "route": "cuda",
        "source": "yolov4_tpu_torch/csrc/bn_act.cu",
        "replaces": None,
        "replaces_note": "no TPU kernel: XLA fuses BN and the activation "
                         "into the conv; on the card it replaces the eager "
                         "BatchNorm2d and activation passes after each "
                         "eval conv of models/layers.ConvBNAct",
        # a 608/b64 Predictor batch with and without PALLAS_CSP, and the
        # 608/b8 train steps of phase 10
        "launches_per_forward": {
            k: v["batch_norm_act"]
            for k, v in report["bn_act"]["launches"].items()},
        "launches_per_train_step": report["train_full"][
            "kernel_launches_per_step"]["batch_norm_act"],
        "max_ulps_bf16": max(r["max_ulps_bf16"] for r in bn_sites),
        "max_rel_err_f32": max(r["max_rel_err_f32"] for r in bn_sites),
        "ms": sum(r["ms"] for r in bn_sites),
        "device_ms": sum(r["device_ms"] for r in bn_sites),
        "plain_ms": sum(r["plain_ms"] for r in bn_sites),
        "bound_ms": sum(r["bound_ms"] for r in bn_sites),
        "bound_by": "bytes",
        "library_ms": None,
        "library_note": "no single PyTorch call computes eval BN and Mish "
                        "or leaky ReLU in one pass; chain_ms is the "
                        "BatchNorm2d and activation passes that ConvBNAct "
                        "runs where the kernel does not",
        "chain_ms": sum(r["chain_ms"] for r in bn_sites),
        "enqueue_us": report["bn_act"]["enqueue_us"],
        "per_site": bn_sites,
    }], "library_products": [{
        # not a TPU kernel: the JAX package's int8 product is XLA's
        # conv_general_dilated (s8 x s8 -> s32), so the port calls
        # cuBLASLt's int8 GEMM through torch._int_mm; per-forward sums over
        # the int8 sites of a 608/b16 forward (span full, u8 stem)
        "name": "int8_conv",
        "route": "library",
        "source": "yolov4_tpu_torch/ops/int8.py",
        "replaces": "yolov4_tpu/models/layers.py:341 (_quant_conv's "
                    "conv_general_dilated)",
        "launches": int8_n,
        "max_abs_err": 0,
        "ms": int8_products["forward_ms"],
        "device_ms": int8_products["forward_device_ms"],
        "int_mm_ms": int8_products["forward_int_mm_ms"],
        "plain_ms": int8_products["forward_plain_ms"],
        "bound_ms": int8_products["forward_bound_ms"],
        "bound_by": ("operations" if all(
            r["bound_by"] == "operations" for r in int8_products["shapes"])
            else "bytes"),
        "library_ms": None,
        "library_note": "PyTorch has no int8 convolution on CUDA; "
                        "cudnn_bf16_ms is cuDNN's bf16 conv of each shape",
        "cudnn_bf16_ms": int8_products["forward_cudnn_bf16_ms"],
        "sites_per_forward": int8_products["sites"],
        "per_shape": int8_products["shapes"],
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
