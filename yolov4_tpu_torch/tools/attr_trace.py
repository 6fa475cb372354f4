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
around every module's forward, ``input`` and ``postprocess`` around the
program's work outside the model, and ``run`` around each call. Each device activity (kernel,
memcpy, memset) is attributed to the innermost scope around the CPU op
that launched it (the activity's external id), else around its runtime
call (its correlation id), else, for K1's and K2's kernels, which launch
through ``ctypes`` from an nvcc-built library, to the call of their custom
op (``yolov4_tpu_torch::greedy_nms_mask``, ``::fused_csp_stage``) that
holds the same place in the order of such calls. It prints the kernels
with their scopes, the totals per scope group (the path's first
``--group-depth`` parts), the share left unattributed, and then all of it
as one JSON line; the groups, the unattributed share included, add up to
the traced device time. ``--trace-dir`` keeps the Chrome trace
(``trace.json``). With ``--device cpu`` the CPU ops' self time is
attributed instead: plumbing only, no device metric.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import tempfile
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

ITERS = 3
# the scope around each profiled call
RUN_SCOPE = "run"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# K1's and K2's kernels (by name prefix) and the custom op that launches them
CUSTOM_OPS = (("nms_", "yolov4_tpu_torch::greedy_nms_mask"),
              ("csp_", "yolov4_tpu_torch::fused_csp_stage"))
UNATTRIBUTED = "(unattributed)"


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


@contextmanager
def program_scopes() -> Iterator[set]:
    """``input`` and ``postprocess`` scopes around engine/predictor's
    calls of model_input and postprocess; yields the scope names."""
    from yolov4_tpu_torch.engine import predictor as mod
    saved = mod.model_input, mod.postprocess

    def scoped(name, fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with record_function(name):
                return fn(*args, **kwargs)
        return call

    mod.model_input = scoped("input", saved[0])
    mod.postprocess = scoped("postprocess", saved[1])
    try:
        yield {"input", "postprocess"}
    finally:
        mod.model_input, mod.postprocess = saved


def innermost(spans: List[dict], queries: List[tuple]) -> List[Optional[str]]:
    """For each query (tid, t), the name of the innermost span on thread
    tid open at time t, or None: one sweep per thread over the spans in
    start order (spans on one thread nest)."""
    by_tid = defaultdict(list)
    for s in spans:
        by_tid[s["tid"]].append((s["ts"], s["ts"] + s["dur"], s["name"]))
    per_tid = defaultdict(list)
    for i, (tid, t) in enumerate(queries):
        per_tid[tid].append((t, i))
    out: List[Optional[str]] = [None] * len(queries)
    for tid, items in per_tid.items():
        ordered = sorted(by_tid.get(tid, ()), key=lambda s: (s[0], -s[1]))
        stack, j = [], 0
        for t, i in sorted(items):
            while j < len(ordered) and ordered[j][0] <= t:
                stack.append(ordered[j])
                j += 1
            while stack and stack[-1][1] <= t:
                stack.pop()
            out[i] = stack[-1][2] if stack else None
    return out


def _mid(e: dict) -> float:
    return e["ts"] + e["dur"] / 2


def _custom_op_owners(work: List[dict], how: List[Optional[str]],
                      ops: List[dict]) -> Dict[int, dict]:
    """Device work left unlinked around K1's and K2's kernels. On each
    stream, linked work splits the unlinked into runs; the j-th run that
    holds kernels of one family belongs, whole, to the j-th call of that
    family's custom op. A family whose runs and calls do not pair up
    stays unattributed."""
    streams = defaultdict(list)
    for i, e in enumerate(work):
        streams[(e["pid"], e["tid"])].append(i)
    runs = []
    for idx in streams.values():
        run = []
        for i in sorted(idx, key=lambda i: work[i]["ts"]):
            if how[i] is None:
                run.append(i)
            elif run:
                runs.append(run)
                run = []
        if run:
            runs.append(run)
    runs.sort(key=lambda r: work[r[0]]["ts"])
    owners = {}
    for prefix, op_name in CUSTOM_OPS:
        calls = sorted((e for e in ops if e["name"] == op_name),
                       key=lambda e: e["ts"])
        mine = [r for r in runs
                if any(work[i]["name"].startswith(prefix) for i in r)]
        if mine and len(mine) == len(calls):
            for run, call in zip(mine, calls):
                owners.update({i: call for i in run})
    return owners


def attribute(events: Sequence[dict], scope_names: set,
              device: str) -> List[dict]:
    """Each unit of work of the trace with its scope: on CUDA each device
    activity, on the CPU each CPU op's self time. Returns [{name, op,
    scope, us, how}], ``how`` being how the scope was found ("op",
    "runtime", "custom_op"; None leaves the scope UNATTRIBUTED)."""
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    scopes = [e for e in spans if e.get("cat") == "user_annotation"
              and e["name"] in scope_names]
    ops = [e for e in spans if e.get("cat") == "cpu_op"]
    if device == "cpu":
        return _attribute_cpu(ops, scopes)
    by_ext = {e["args"]["External id"]: e for e in spans
              if e.get("cat") in ("cpu_op", "user_annotation")
              and e.get("args", {}).get("External id")}
    by_corr = {e["args"]["correlation"]: e for e in spans
               if e.get("cat") in ("cuda_runtime", "cuda_driver")
               and "correlation" in e.get("args", {})}
    work = [e for e in spans if e.get("cat") in DEVICE_CATS]
    launchers: List[Optional[dict]] = []
    how: List[Optional[str]] = []
    for e in work:
        args = e.get("args", {})
        op = by_ext.get(args.get("External id"))
        runtime = by_corr.get(args.get("correlation"))
        launchers.append(op or runtime)
        how.append("op" if op else "runtime" if runtime else None)
    for i, call in _custom_op_owners(work, how, ops).items():
        launchers[i], how[i] = call, "custom_op"
    found = [i for i, e in enumerate(launchers) if e is not None]
    names = innermost(scopes, [(launchers[i]["tid"], _mid(launchers[i]))
                               for i in found])
    scope = dict(zip(found, names))
    rows = []
    for i, e in enumerate(work):
        name = scope.get(i)
        rows.append(dict(name=e["name"], us=float(e["dur"]),
                         op=launchers[i]["name"] if launchers[i] else None,
                         scope=name or UNATTRIBUTED,
                         how=how[i] if name else None))
    return rows


def _attribute_cpu(ops: List[dict], scopes: List[dict]) -> List[dict]:
    """Each CPU op's self time (its time less its child ops') in the
    innermost scope around it."""
    self_us = [float(e["dur"]) for e in ops]
    by_tid = defaultdict(list)
    for i, e in enumerate(ops):
        by_tid[e["tid"]].append(i)
    for idx in by_tid.values():
        stack = []
        for i in sorted(idx, key=lambda i: (ops[i]["ts"], -ops[i]["dur"])):
            while stack and ops[stack[-1]]["ts"] + ops[stack[-1]]["dur"] \
                    <= ops[i]["ts"]:
                stack.pop()
            if stack:
                self_us[stack[-1]] -= float(ops[i]["dur"])
            stack.append(i)
    names = innermost(scopes, [(e["tid"], _mid(e)) for e in ops])
    return [dict(name=e["name"], op=e["name"], us=max(us, 0.0),
                 scope=name or UNATTRIBUTED, how="op" if name else None)
            for e, us, name in zip(ops, self_us, names)]


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
                with record_function("postprocess"):
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
    with module_scopes(pred.model) as names, program_scopes() as extra:
        with profile(activities=activities) as prof:
            for _ in range(ITERS):
                with record_function(RUN_SCOPE):
                    call()
            sync()
    with tempfile.TemporaryDirectory() as tmp:
        trace_dir = args.trace_dir or tmp
        os.makedirs(trace_dir, exist_ok=True)
        path = os.path.join(trace_dir, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    rows = attribute(events, names | extra | {RUN_SCOPE}, device.type)
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
