"""Where the device time of the detection path goes, by kernel.

Usage (on a machine with a CUDA card):

    python -m yolov4_tpu_torch.tools.profile_forward [--pallas-csp]

Builds the full-width Predictor of the default config (608x608, bfloat16,
seed-0 random weights) at batch 16, runs ``Predictor.run`` on one uploaded
uint8 batch three times under ``torch.profiler``, and prints the device
time per batch by kernel group (the CSP stage kernel, convolution,
elementwise, batchnorm, top-k/sort, the NMS kernel, other), the 15 most
expensive kernels, and the device busy share of the profiled window, then
all of it as one JSON line. ``--pallas-csp`` profiles the
``MODEL.PALLAS_CSP`` forward (CSP stages 1-3 through K2).
"""

from __future__ import annotations

import argparse
import json
import time
from collections import defaultdict

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from yolov4_tpu_torch.config import load_config
from yolov4_tpu_torch.engine.predictor import Predictor

BATCH, ITERS = 16, 3

# first matching substring (of the lower-cased kernel name) decides the group
GROUPS = (
    ("csp kernel", ("csp_wgmma_kernel", "csp_conv_kernel")),
    ("nms kernel", ("nms_mask_kernel", "nms_scan_kernel")),
    ("convolution", ("conv", "gemm", "sm90_xmma", "cutlass", "implicit",
                     "winograd", "dgrad", "wgrad", "fprop")),
    ("batchnorm", ("batch_norm", "bn_fw", "bn_bw", "batchnorm")),
    ("top-k / sort", ("topk", "sort", "radix", "gather_topk", "bitonic")),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "reduce",
                     "cat", "copy", "index", "gather", "scatter")),
)


def group_of(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--pallas-csp", action="store_true",
                        help="profile the MODEL.PALLAS_CSP fused-stage forward")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_forward needs a CUDA card")
    cfg = load_config(None)
    cfg["MODEL"]["PALLAS_CSP"] = args.pallas_csp
    size = cfg["TEST"]["IMGSIZE"]
    pred = Predictor(cfg, img_size=size, batch_size=BATCH)
    images = np.random.default_rng(0).integers(
        0, 256, (BATCH, size, size, 3), dtype=np.uint8)
    x = pred.upload(images)
    for _ in range(3):
        pred.run(x)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(ITERS):
            pred.run(x)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    by_kernel = defaultdict(float)
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[evt.name] += evt.device_time_total / 1e3  # us -> ms
    groups = defaultdict(float)
    for name, ms in by_kernel.items():
        groups[group_of(name)] += ms / ITERS
    device_ms = sum(groups.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:15]
    result = {
        "device": torch.cuda.get_device_name(0),
        "batch": BATCH, "img_size": size,
        "dtype": cfg["MODEL"]["COMPUTE_DTYPE"],
        "pallas_csp": args.pallas_csp,
        "wall_ms_per_batch": wall_ms / ITERS,
        "device_ms_per_batch": device_ms,
        "busy_share": device_ms * ITERS / wall_ms,
        "groups_ms_per_batch": dict(sorted(groups.items(),
                                           key=lambda kv: -kv[1])),
        "top_kernels_ms_per_batch": [(n[:120], ms / ITERS)
                                     for n, ms in top],
    }
    print(f"{result['device']}: batch {BATCH} at {size}, "
          f"{result['dtype']}, PALLAS_CSP {args.pallas_csp}: "
          f"device {device_ms:.3f} ms / batch, wall "
          f"{result['wall_ms_per_batch']:.3f} ms, busy "
          f"{result['busy_share']:.3f}")
    for group, ms in result["groups_ms_per_batch"].items():
        print(f"  {group:14s} {ms:9.3f} ms  {ms / device_ms:6.1%}")
    for name, ms in result["top_kernels_ms_per_batch"]:
        print(f"  {ms:9.3f} ms  {name}")
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
