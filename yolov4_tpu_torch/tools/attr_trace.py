"""Device time of the detection program by model scope: the port's copy of
the JAX package's tools/attr_trace.py.

Usage (on a machine with a CUDA card):

    python -m yolov4_tpu_torch.tools.attr_trace [--target fwd|serve]
        [--img-size 608] [--batch 16] [--with-nms] [--pallas-csp]
        [--quant none|int8|int8_static] [--span late|full]
        [--group-depth 3] [--top 40] [--trace-dir DIR] [--device cuda]

Builds the model of the default config (full width, bfloat16, seed-0
weights) and profiles ITERS calls of the program under ``torch.profiler``:
``--target fwd`` the model's forward (decode included; with ``--with-nms``
the postprocess too) on float images, ``--target serve`` ``Predictor.run``
on an uploaded uint8 batch (normalize, forward, decode, postprocess).

Scopes are the counterpart of the JAX package's flax named scopes: a
``record_function`` named by the ``nn.Module`` path (e.g.
``backbone.stage4.blocks.2.conv2``; the root module is ``model``) is open
around every module's forward, the program's own spans
(utils/profiling.SPANS: ``predictor.program`` with the input cast,
``model.backbone``, ``model.neck``, ``model.head`` with the decode,
``postprocess``) around its layers, and ``run`` around each call. Each
device activity (kernel, memcpy, memset) is attributed to the innermost
scope around its launch (utils/profiling.attribute: the CPU op of its
external id, else its runtime call's correlation id, else, for K1's and
K2's kernels, which launch through ``ctypes`` from an nvcc-built library,
the call of their custom op, ``yolov4_tpu_torch::greedy_nms_mask`` or
``::fused_csp_stage``, that holds the same place in the order of such
calls). It prints the kernels
with their scopes, the totals per scope group (the path's first
``--group-depth`` parts), the share left unattributed, and then all of it
as one JSON line; the groups, the unattributed share included, add up to
the traced device time. ``--trace-dir`` keeps the Chrome trace
(``trace.json``). With ``--device cpu`` the CPU ops' self time is
attributed instead: plumbing only, no device metric.
"""

from __future__ import annotations

import argparse
import json
import os
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch
from torch import nn
from torch.autograd.profiler import record_function
from torch.profiler import ProfilerActivity, profile

from yolov4_tpu_torch.config import Config, load_config
from yolov4_tpu_torch.engine.predictor import Predictor
from yolov4_tpu_torch.ops.postprocess import postprocess
from yolov4_tpu_torch.utils.profiling import (SPANS, UNATTRIBUTED, attribute,
                                              chrome_events, span)

ITERS = 3
# the scope around each profiled call
RUN_SCOPE = "run"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--img-size", type=int, default=608)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--trace-dir", default=None,
                   help="keep the Chrome trace here (trace.json)")
    p.add_argument("--with-nms", action="store_true",
                   help="--target fwd: the postprocess too")
    p.add_argument("--top", type=int, default=40,
                   help="rows of each table (0 = all)")
    p.add_argument("--group-depth", type=int, default=3,
                   help="scope path depth for the aggregate table")
    p.add_argument("--quant", choices=["none", "int8", "int8_static"],
                   default="none", help="MODEL.QUANT")
    p.add_argument("--span", choices=["late", "full"], default=None,
                   help="MODEL.QUANT_SPAN override")
    p.add_argument("--target", choices=["fwd", "serve"], default="fwd",
                   help="serve profiles Predictor.run")
    p.add_argument("--pallas-csp", action="store_true",
                   help="MODEL.PALLAS_CSP (stages 1-3 through K2)")
    p.add_argument("--device", default="cuda")
    return p


@contextmanager
def module_scopes(model: nn.Module) -> Iterator[set]:
    """A ``record_function`` named by its module path around every
    module's forward; yields the scope names."""
    open_scopes = []

    def enter(name):
        def hook(module, args):
            scope = record_function(name)
            scope.__enter__()
            open_scopes.append(scope)
        return hook

    def leave(module, args, output):
        open_scopes.pop().__exit__(None, None, None)

    names, handles = set(), []
    for name, module in model.named_modules():
        name = name or "model"
        names.add(name)
        handles.append(module.register_forward_pre_hook(enter(name)))
        handles.append(module.register_forward_hook(leave, always_call=True))
    try:
        yield names
    finally:
        for h in handles:
            h.remove()


def group_of(scope: str, depth: int) -> str:
    return ".".join(scope.split(".")[:depth]) if depth > 0 else scope


def summarize(rows: List[dict], depth: int, iters: int) -> Dict:
    """Per-kernel rows (by kernel and scope), per-scope-group totals and
    the unattributed share; ms per iteration."""
    total = sum(r["us"] for r in rows)
    kernels, groups, how = defaultdict(float), defaultdict(float), \
        defaultdict(int)
    for r in rows:
        kernels[(r["name"], r["scope"])] += r["us"]
        groups[group_of(r["scope"], depth)] += r["us"]
        how[r["how"] or "none"] += 1
    per_iter = 1e3 * iters
    return dict(
        total_ms=total / per_iter,
        unattributed_share=(sum(r["us"] for r in rows
                                if r["scope"] == UNATTRIBUTED)
                            / total if total else 0.0),
        groups_ms=dict(sorted(((g, us / per_iter) for g, us in groups.items()),
                              key=lambda kv: -kv[1])),
        kernels_ms=sorted(([n, s, us / per_iter]
                           for (n, s), us in kernels.items()),
                          key=lambda r: -r[2]),
        attributed_by=dict(how))


def build_cfg(args: argparse.Namespace, cfg: Optional[Config] = None
              ) -> Config:
    """The default config (or ``cfg``) with the flags' MODEL settings."""
    cfg = load_config(None) if cfg is None else cfg
    cfg["MODEL"]["PALLAS_CSP"] = args.pallas_csp
    cfg["MODEL"]["QUANT"] = args.quant
    if args.span:
        cfg["MODEL"]["QUANT_SPAN"] = args.span
    return cfg


def _program(cfg: Config, args: argparse.Namespace):
    """The profiled call and the device it runs on."""
    pred = Predictor(cfg, img_size=args.img_size, batch_size=args.batch,
                     device=args.device)
    rng = np.random.default_rng(0)
    if args.target == "serve":
        images = rng.integers(0, 256, (args.batch, args.img_size,
                                       args.img_size, 3), dtype=np.uint8)
        pred.calibrate(images)      # int8_static only
        x = pred.upload(images)
        return (lambda: pred.run(x)), pred
    x = torch.from_numpy(rng.random((args.batch, 3, args.img_size,
                                     args.img_size), dtype=np.float32))
    x = x.to(pred.device).contiguous(memory_format=torch.channels_last)
    if pred.quant == "int8_static":
        pred.calibrate((x.permute(0, 2, 3, 1) * 255).round().byte()
                       .cpu().numpy())

    @torch.inference_mode()
    def forward():
        with pred._scope(pred.device):
            out = pred.model(x)
            if args.with_nms:
                with span("postprocess"):
                    out = postprocess(out, pred.num_classes, 0.005, 0.4,
                                      pre_nms_topk=2048, max_dets=100)
            return out

    return forward, pred


def run(cfg: Config, args: argparse.Namespace) -> Dict:
    call, pred = _program(cfg, args)
    device = pred.device
    sync = (lambda: torch.cuda.synchronize(device)) \
        if device.type == "cuda" else (lambda: None)
    for _ in range(3):
        call()
    sync()
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with module_scopes(pred.model) as names:
        with profile(activities=activities) as prof:
            for _ in range(ITERS):
                with record_function(RUN_SCOPE):
                    call()
            sync()
    if args.trace_dir:
        os.makedirs(args.trace_dir, exist_ok=True)
    events = chrome_events(prof, args.trace_dir and os.path.join(
        args.trace_dir, "trace.json"))
    rows = attribute(events, names | set(SPANS) | {RUN_SCOPE}, device.type)
    summary = summarize(rows, args.group_depth, ITERS)
    result = {
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "target": args.target, "img_size": args.img_size,
        "batch": args.batch, "iters": ITERS,
        "dtype": cfg["MODEL"]["COMPUTE_DTYPE"],
        "pallas_csp": args.pallas_csp, "quant": args.quant,
        "span": cfg["MODEL"].get("QUANT_SPAN"), "with_nms": args.with_nms,
        "group_depth": args.group_depth,
        # device time per call on a card; CPU ops' self time on the CPU
        ("device_ms_per_iter" if device.type == "cuda"
         else "cpu_op_ms_per_iter"): summary["total_ms"],
        "unattributed_share": summary["unattributed_share"],
        "attributed_by": summary["attributed_by"],
        "groups_ms_per_iter": summary["groups_ms"],
        "kernels_ms_per_iter": summary["kernels_ms"][:args.top or None],
    }
    top = args.top or None
    total = summary["total_ms"]
    print(f"{result['device']}: {args.target} at {args.img_size}/b"
          f"{args.batch} {result['dtype']} PALLAS_CSP {args.pallas_csp} "
          f"QUANT {args.quant}: {total:.3f} ms per call traced, "
          f"{100 * result['unattributed_share']:.3f}% unattributed")
    print(f"{'kernel':48s} {'ms':>9s} {'%':>6s}  scope")
    for name, scope, ms in summary["kernels_ms"][:top]:
        print(f"{name[:48]:48s} {ms:9.3f} {100 * ms / total:6.2f}  "
              f"{scope[:80]}")
    print(f"\nper-scope-group (depth {args.group_depth}):")
    for group, ms in list(summary["groups_ms"].items())[:top]:
        print(f"  {ms:9.3f} ms {100 * ms / total:6.2f}%  {group[:100]}")
    print(f"  TOTAL {total:.3f} ms per call over the traced window")
    print(json.dumps(result))
    return result


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    args = build_parser().parse_args(argv)
    return run(build_cfg(args), args)


if __name__ == "__main__":
    main()
