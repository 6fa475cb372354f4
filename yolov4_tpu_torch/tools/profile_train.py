"""Where the device time of a train step goes, by phase and kernel group.

Usage (on a machine with a CUDA card):

    python -m yolov4_tpu_torch.tools.profile_train [--batch 8] [--size 608]

Builds the full-width YOLOv4 of the default config for training (float32
weights, bfloat16 autocast, Adam, channels-last) and its step,
``parallel/train_step.make_train_step``, draws one batch of random images
and boxes, takes three warm steps, and then profiles ``--iters`` steps in
one ``torch.profiler`` window. The phases are the step's own spans
(``train.forward``, ``train.loss``, ``train.backward``, ``train.update``):
each device activity goes to the span around its launch
(utils/profiling.attribute; the backward's, launched from autograd's
device thread, to ``train.backward``), and what no span holds to
``(outside)``. Prints, per phase, the device time per step by kernel
group (the groups of tools/profile_forward.py plus the optimizer's
multi-tensor kernels), its host time outside CUDA runtime calls and the
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
from yolov4_tpu_torch.parallel.train_step import (TrainState,
                                                  images_to_input,
                                                  make_train_step)
from yolov4_tpu_torch.tools.profile_forward import GROUPS
from yolov4_tpu_torch.utils.profiling import (attribute, chrome_events,
                                              span_host)

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bfloat16 (NVIDIA data sheet)
TRAIN_GROUPS = (("optimizer", ("multi_tensor", "foreach", "adam")),) + GROUPS
PHASES = ("train.forward", "train.loss", "train.backward", "train.update")
OUTSIDE = "(outside)"


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
    optimizer = build_optimizer(cfg, model)
    lr = optimizer.param_groups[0]["lr"]
    step = make_train_step(model, build_criterion(cfg), optimizer,
                           lambda _: lr, compute_dtype=torch.bfloat16)
    state = TrainState()
    images, labels = random_batch(args.batch, args.size)
    flops = 3.0 * forward_conv_flops(model, images_to_input(images))

    def steps(n):
        nonlocal state
        for _ in range(n):
            state = step(state, images, labels)

    steps(3)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        steps(args.iters)
        torch.cuda.synchronize()
    events = chrome_events(prof)
    phases = {name: defaultdict(float) for name in PHASES + (OUTSIDE,)}
    kernels = {name: defaultdict(float) for name in phases}
    for r in attribute(events, set(PHASES), "cuda"):
        name = r["scopes"][0] if r["scopes"] else OUTSIDE
        ms = r["us"] / 1e3 / args.iters
        phases[name][group_of(r["name"])] += ms
        kernels[name][r["name"]] += ms
    host = span_host(events, PHASES)

    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    n = 10
    start.record()
    steps(n)
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
        "phases_host_ms": {name: sum(us) / 1e3 / args.iters
                           for name, us in host.items()},
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
        print(f"  {name}: {total:.3f} ms device time per step, host "
              f"{result['phases_host_ms'].get(name, 0.0):.3f} ms")
        for group, ms in groups.items():
            print(f"    {group:14s} {ms:9.3f} ms  {ms / total:6.1%}")
        for kname, ms in result["top_kernels_ms"][name][:5]:
            print(f"    {ms:9.3f} ms  {kname}")
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
