"""Where the device time of a train step goes, by phase and kernel group.

Usage (on a machine with a CUDA card):

    python -m yolov4_tpu_torch.tools.profile_train [--batch 8] [--size 608]

Builds the full-width YOLOv4 of the default config for training (float32
weights, bfloat16 autocast, Adam, channels-last), draws one batch of
random images and boxes, takes three warm steps, and then profiles
``--iters`` steps with ``torch.profiler``, one profiler window per phase
in the order of ``parallel/train_step.py``: forward + loss, backward,
optimizer update (with the zeroing of the gradients). Prints, per phase,
the device time per step by kernel group (the groups of
tools/profile_forward.py plus the optimizer's multi-tensor kernels), the
10 most expensive kernels, then the step's time from CUDA events outside
the profiler, its peak memory, and the share of the card's bfloat16 peak
that the model's FLOPs reach (train FLOPs = 3x the forward's, counted
from the convolutions' shapes); then all of it as one JSON line.
"""

from __future__ import annotations

import argparse
import json
from collections import defaultdict

import numpy as np
import torch
from torch import nn
from torch.profiler import ProfilerActivity, profile

from yolov4_tpu_torch.config import load_config
from yolov4_tpu_torch.models import build_model
from yolov4_tpu_torch.ops.loss import build_criterion
from yolov4_tpu_torch.optim import build_optimizer
from yolov4_tpu_torch.parallel.train_step import images_to_input
from yolov4_tpu_torch.tools.profile_forward import GROUPS

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bfloat16 (NVIDIA data sheet)
TRAIN_GROUPS = (("optimizer", ("multi_tensor", "foreach", "adam")),) + GROUPS


def group_of(name: str) -> str:
    low = name.lower()
    for group, keys in TRAIN_GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def forward_conv_flops(model: nn.Module, x: torch.Tensor) -> float:
    """FLOPs (2 per multiply-add) of the convolutions of one forward of
    ``model`` on ``x``, from their shapes."""
    total = [0.0]

    def hook(mod, _inp, out):
        k = mod.kernel_size[0] * mod.kernel_size[1]
        total[0] += (2.0 * out.numel() * k * mod.in_channels
                     / mod.groups)

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, nn.Conv2d)]
    try:
        with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
            model(x)
    finally:
        for h in handles:
            h.remove()
    return total[0]


def random_batch(batch: int, size: int, seed: int = 0, device="cuda"):
    """bfloat16 NHWC images in [0, 1] and [B, 60, 5] labels with 1-6
    boxes per image, on ``device``."""
    rng = np.random.default_rng(seed)
    imgs = torch.from_numpy(rng.random((batch, size, size, 3),
                                       dtype=np.float32))
    labels = np.zeros((batch, 60, 5), np.float32)
    for b in range(batch):
        for k in range(int(rng.integers(1, 7))):
            w, h = rng.uniform(0.05, 0.6, 2) * size
            cx, cy = rng.uniform(w / 2, size - w / 2), rng.uniform(h / 2,
                                                                   size - h / 2)
            labels[b, k] = [cx, cy, w, h, rng.integers(0, 80)]
    return (imgs.to(torch.bfloat16).to(device),
            torch.from_numpy(labels).to(device))


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--size", type=int, default=608)
    parser.add_argument("--iters", type=int, default=3)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a CUDA card")
    cfg = load_config(None)
    model = build_model(cfg, device="cuda", train=True)
    model = model.to(memory_format=torch.channels_last).train()
    criterion = build_criterion(cfg)
    optimizer = build_optimizer(cfg, model)
    images, labels = random_batch(args.batch, args.size)
    x = images_to_input(images)
    flops = 3.0 * forward_conv_flops(model, x)

    def forward_loss():
        with torch.autocast("cuda", dtype=torch.bfloat16):
            outputs = model(images_to_input(images))
        return criterion(outputs, {"padded_labels": labels})

    def update():
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)

    def step():
        forward_loss().backward()
        update()

    for _ in range(3):
        step()
    torch.cuda.synchronize()

    phases = {"forward+loss": defaultdict(float), "backward": defaultdict(float),
              "optimizer": defaultdict(float)}
    kernels = {name: defaultdict(float) for name in phases}

    def run_profiled(name, fn):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            out = fn()
            torch.cuda.synchronize()
        for evt in prof.events():
            # the optimizer's record_function range shows on the device
            # timeline too; it spans kernels counted on their own
            if (evt.device_type == torch.autograd.DeviceType.CUDA
                    and not evt.name.startswith("Optimizer.")):
                ms = evt.device_time_total / 1e3 / args.iters
                phases[name][group_of(evt.name)] += ms
                kernels[name][evt.name] += ms
        return out

    for _ in range(args.iters):
        loss = run_profiled("forward+loss", forward_loss)
        run_profiled("backward", loss.backward)
        run_profiled("optimizer", update)

    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    n = 10
    start.record()
    for _ in range(n):
        step()
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / n
    result = {
        "device": torch.cuda.get_device_name(0),
        "batch": args.batch, "img_size": args.size, "dtype": "bfloat16",
        "params": sum(p.numel() for p in model.parameters()),
        "step_ms": step_ms, "img_s": args.batch * 1e3 / step_ms,
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "train_gflop": flops / 1e9,
        "flop_share_of_bf16_peak": flops / (step_ms * 1e-3) / PEAK_BF16_FLOPS,
        "phases_device_ms": {name: sum(g.values())
                             for name, g in phases.items()},
        "groups_ms": {name: dict(sorted(g.items(), key=lambda kv: -kv[1]))
                      for name, g in phases.items()},
        "top_kernels_ms": {name: [(k[:100], ms) for k, ms in sorted(
            kv.items(), key=lambda kv: -kv[1])[:10]]
            for name, kv in kernels.items()},
    }
    print(f"{result['device']}: train step, batch {args.batch} at "
          f"{args.size}, bf16 autocast: {step_ms:.3f} ms "
          f"({result['img_s']:.1f} img/s), peak "
          f"{result['peak_memory_gib']:.2f} GiB, "
          f"{result['train_gflop']:.0f} GFLOP "
          f"({result['flop_share_of_bf16_peak']:.1%} of the bf16 peak)")
    for name, groups in result["groups_ms"].items():
        total = result["phases_device_ms"][name]
        print(f"  {name}: {total:.3f} ms device time per step")
        for group, ms in groups.items():
            print(f"    {group:14s} {ms:9.3f} ms  {ms / total:6.1%}")
        for kname, ms in result["top_kernels_ms"][name][:5]:
            print(f"    {ms:9.3f} ms  {kname}")
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
