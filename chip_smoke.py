#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (yolov4_tpu_torch) on one NVIDIA GPU.

Usage (from the root of a checkout, on a machine with a CUDA card and the
CUDA toolkit):

    python3 chip_smoke.py

Phases; any failure ends the run with a non-zero exit code and no result
line:

  1. build   — compile yolov4_tpu_torch/csrc/nms.cu with nvcc for sm_90a.
  2. kernel  — the greedy-NMS kernel (K1) against its plain PyTorch version
               on the card: keep masks bit-equal on the cases of
               tests/test_nms_pallas.py, a ragged K, and the main-path shape
               (B=16, K=2048, t=0.4, class-offset coordinates).
  3. main    — the detection path at the full width of YOLOv4
               (CSPDarknet53, 80 classes, 608x608, batch 16, bfloat16,
               seeded random weights) through Predictor: launches counted,
               outputs checked, the same decoded predictions through the
               plain NMS give identical detections; K1 and the plain version
               timed on the NMS inputs this path produced.
  4. device  — the port at WIDTH 0.25 in float32 (TF32 off) on the card
               against the same model on the CPU, decoded predictions
               within atol = rtol = 1e-3.
  5. detect  — ``python -m yolov4_tpu_torch.detect``'s entry point on four
               synthetic JPEGs writes four drawn images.

Then it prints the card's name and power limit (nvidia-smi), one JSON line
``{"kernels": [...]}`` and, last, ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet): float32 outside the tensor
# cores, and HBM3 bandwidth.
PEAK_F32_OPS = 67e12
PEAK_BYTES = 3.35e12
# float32 operations of the kernel's pair test (Pallas formula): 2 min,
# 2 max, 2 sub, 2 clamp for iw/ih; 1 mul; 1 add + 1 sub + 1 clamp for the
# union; 1 div; 1 compare
OPS_PER_PAIR = 14
OPS_PER_BOX = 3  # area


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median device time of one call of ``fn``, from CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
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


def phase_kernel_cases(nms_cuda, plain):
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
    boxes, valid = nms_case(21, 16, 2048, 0.9, 608.0, 300.0)
    cls = np.random.default_rng(22).integers(0, 80, (16, 2048, 1))
    span = np.float32(2.0 * np.abs(boxes).max() + 1.0)
    cases.append(((boxes + cls * span).astype(np.float32), valid, 0.4))
    err = 0.0
    for i, (boxes, valid, t) in enumerate(cases):
        bx = torch.from_numpy(boxes).cuda()
        vd = torch.from_numpy(valid).cuda()
        got = nms_cuda.greedy_nms_mask_cuda(bx, vd, t)
        torch.cuda.synchronize()
        want = plain(bx, vd, t)
        if not torch.equal(got, want):
            raise AssertionError(
                f"K1 case {i} {tuple(boxes.shape)}: keep masks differ at "
                f"{int((got != want).sum())} positions")
        err = max(err, float((got.float() - want.float()).abs().max()))
    # batch isolation: each image alone gives its row of the batched mask
    boxes, valid = nms_case(5, 4, 256)
    bx, vd = torch.from_numpy(boxes).cuda(), torch.from_numpy(valid).cuda()
    full = nms_cuda.greedy_nms_mask_cuda(bx, vd, 0.5)
    for i in range(4):
        solo = nms_cuda.greedy_nms_mask_cuda(bx[i:i + 1], vd[i:i + 1], 0.5)
        if not torch.equal(full[i], solo[0]):
            raise AssertionError(f"K1 batch isolation: image {i} differs")
    log(f"[kernel] {len(cases)} cases + batch isolation bit-equal to the "
        f"plain version, max_abs_err {err}")
    return err


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


def phase_device_vs_cpu(cfg_cls, build_model, report):
    """WIDTH 0.25 float32 on the card (TF32 off) against the CPU."""
    cfg = cfg_cls.from_dict({
        "MODEL": {"WIDTH": 0.25, "DEPTH": 0.25, "COMPUTE_DTYPE": "float32"},
        "TEST": {"IMGSIZE": 320}})
    model = build_model(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(1))
    # BN re-drawn away from the reference's N(0, 0.01) scales, which would
    # decay every activation to ~0 and make the comparison vacuous
    rng = np.random.default_rng(1)
    sd = model.state_dict()
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
    model.load_state_dict(sd)
    model.eval()
    gpu = build_model(cfg, device="cuda")
    gpu.load_state_dict(sd)
    gpu.eval()
    x = torch.from_numpy(rng.random((2, 3, 320, 320), dtype=np.float32))
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.inference_mode():
            want = model(x).numpy()
            got = gpu(x.cuda()).cpu().numpy()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    from yolov4_tpu_torch import detect as detect_mod
    from yolov4_tpu_torch.config import Config, load_config
    from yolov4_tpu_torch.engine.predictor import Predictor
    from yolov4_tpu_torch.models import build_model
    from yolov4_tpu_torch.ops import nms_cuda
    from yolov4_tpu_torch.ops import postprocess as postprocess_mod
    from yolov4_tpu_torch.ops.nms import greedy_nms_mask

    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    report = {}
    t0 = time.time()
    lib = nms_cuda.build()
    report["build_s"] = time.time() - t0
    log(f"[build] {lib.name} in {report['build_s']:.1f}s")

    err = phase_kernel_cases(nms_cuda, greedy_nms_mask)

    cfg = load_config(None)
    captured, launches = phase_main(cfg, nms_cuda, postprocess_mod,
                                    Predictor, report)
    boxes, valid, t = captured[0]
    b, k, _ = boxes.shape
    want = greedy_nms_mask(boxes, valid, t)
    got = nms_cuda.greedy_nms_mask_cuda(boxes, valid, t)
    if not torch.equal(got, want):
        raise AssertionError("K1 differs from the plain version on the main "
                             "path's NMS input")
    ms = cuda_ms(lambda: nms_cuda.greedy_nms_mask_cuda(boxes, valid, t))
    plain_ms = cuda_ms(lambda: greedy_nms_mask(boxes, valid, t), iters=5)
    library_ms = library_nms_ms(boxes, valid, t)
    bound_ms, bound_by = nms_bound(b, k)
    log(f"[kernel] main-path input B={b} K={k} t={t} "
        f"({int(valid.sum())} valid, {int(got.sum())} kept): K1 {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, bound {bound_ms:.5f} ms by {bound_by}, "
        f"library {library_ms}")

    phase_device_vs_cpu(Config, build_model, report)
    phase_detect(detect_mod, nms_cuda, report)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    kernels = {"kernels": [{
        "name": "greedy_nms_mask",
        "route": "cuda",
        "source": "yolov4_tpu_torch/csrc/nms.cu",
        "replaces": "yolov4_tpu/ops/nms_pallas.py:140",
        "launches": launches,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
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
