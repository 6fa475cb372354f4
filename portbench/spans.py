"""The program's spans in a cell's traced window, on the card:

    python3 portbench/spans.py --workload <name> --seed <n> --seconds <s>

The program opens a ``record_function`` range at each of its layer
boundaries while a profiler records (``PROGRAM``: the Predictor's upload
and program, the model's backbone, neck and head, the postprocess, the
train step's forward, loss, backward and update). This runs the cell's
window as a traced run does (``SpanTracer``: portbench/trace.py's
profile, window span and ``parse`` of the same events) and puts each
device operation of the window down to the program spans open around its
launch (``program_spans``, the rules of the program's
utils/profiling.attribute, copied here): the CPU op of its "External
id", else the runtime call of its "correlation", else, for K1's and
K2's kernels, which launch through ``ctypes``, the call of their custom op
in the same place of the order of such calls. Its spans are those open
on the launch's own thread, else, where that thread has none open, those
of the thread whose innermost open span began last (the backward's
launches come from autograd's device thread while ``train.backward`` is
open on the caller's). Device time counts for a span and every span
around it, clipped to the window; a span's host time is its time less the
CUDA runtime and driver calls on its thread, as for the harness's own
spans.

One JSON line: ``readings`` (``READINGS``, by the cell's driver: host ms
a batch, device ms an image of ``driver.traced_images``; a span absent
from the window gives none), the device ms an image and host ms a call of
every span present, the share of the window's busy device time that the
cell's spans cover (``COVER``), the device ms an image outside every
program span, ``busy_s``, ``window_s``, and the window's end-to-end
values (under the profiler).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from portbench import drivers  # noqa: E402
from portbench.run import TRACE_SECONDS, load_cell  # noqa: E402
from portbench.trace import (DEVICE_ACTIVITIES, HOST_ACTIVITIES,  # noqa: E402
                             RUNTIME_ACTIVITIES, WINDOW, Tracer, _covered,
                             _merge, parse)

PROGRAM = ("predictor.upload", "predictor.program", "model.backbone",
           "model.neck", "model.head", "postprocess", "train.forward",
           "train.loss", "train.backward", "train.update")
# K1's and K2's kernels (by name prefix) and the custom op that launches them
CUSTOM_OPS = (("nms_", "yolov4_tpu_torch::greedy_nms_mask"),
              ("csp_", "yolov4_tpu_torch::fused_csp_stage"))
# by the cell's driver: reading -> (span, "host" ms a call or "device" ms
# an image)
READINGS = {
    "detect": {
        "predictor.upload_host_ms.detect": ("predictor.upload", "host"),
        "predictor.program_host_ms.detect": ("predictor.program", "host"),
        "backbone_ms.detect": ("model.backbone", "device"),
        "neck_ms.detect": ("model.neck", "device"),
        "head_ms.detect": ("model.head", "device"),
        "postprocess_ms.detect": ("postprocess", "device")},
    "train": {
        "forward_ms.train": ("train.forward", "device"),
        "loss_ms.train": ("train.loss", "device"),
        "backward_ms.train": ("train.backward", "device"),
        "update_ms.train": ("train.update", "device")},
    "classify": {
        "forward_ms.pretrain": ("train.forward", "device"),
        "backward_ms.pretrain": ("train.backward", "device"),
        "update_ms.pretrain": ("train.update", "device")},
}
# by the cell's driver: the sets of spans whose device time is set
# against the window's busy time
COVER = {
    "detect": {"program": ("predictor.upload", "predictor.program"),
               "parts": ("model.backbone", "model.neck", "model.head",
                         "postprocess")},
    "train": {"phases": ("train.forward", "train.loss", "train.backward",
                         "train.update")},
    "classify": {"phases": ("train.forward", "train.backward",
                            "train.update")},
}


@dataclass
class Program:
    # (start_us, duration_us, spans open around its launch) of every
    # device operation in the window, clipped to it
    ops: List[Tuple[float, float, Tuple[str, ...]]]
    # each span's host seconds a call outside runtime calls on its thread
    host: Dict[str, List[float]] = field(default_factory=dict)
    # how each operation was linked to its launch: "op", "runtime",
    # "custom_op", "none"
    how: Dict[str, int] = field(default_factory=dict)

    def device_seconds(self, *names: str) -> float:
        """Device seconds of the operations launched inside any of the
        spans ``names``."""
        return sum(d for _, d, st in self.ops
                   if any(n in st for n in names)) / 1e6


def _sweep(spans: List[tuple], times: List[float]) -> List[tuple]:
    """The spans of one thread (start, end, name; they nest) open at each
    of ``times``, outermost first."""
    ordered = sorted(spans, key=lambda s: (s[0], -s[1]))
    out: List[tuple] = [()] * len(times)
    stack: List[tuple] = []
    j = 0
    for t, i in sorted((t, i) for i, t in enumerate(times)):
        while j < len(ordered) and ordered[j][0] <= t:
            while stack and stack[-1][1] <= ordered[j][0]:
                stack.pop()
            stack.append(ordered[j])
            j += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        out[i] = tuple(stack)
    return out


def open_spans(spans: List[dict], queries: List[tuple]
               ) -> List[Tuple[str, ...]]:
    """For each query (tid, t), the names of ``spans`` open at t on
    thread tid, else on the thread whose innermost open span began
    last; outermost first."""
    by_tid = defaultdict(list)
    for s in spans:
        by_tid[s["tid"]].append((s["ts"], s["ts"] + s["dur"], s["name"]))
    per_tid = defaultdict(list)
    for i, (tid, _) in enumerate(queries):
        per_tid[tid].append(i)
    found: List[tuple] = [()] * len(queries)
    for tid, idx in per_tid.items():
        for i, st in zip(idx, _sweep(by_tid.get(tid, []),
                                     [queries[i][1] for i in idx])):
            found[i] = st
    empty = [i for i, st in enumerate(found) if not st]
    if empty:
        times = [queries[i][1] for i in empty]
        for tid_spans in by_tid.values():
            for i, st in zip(empty, _sweep(tid_spans, times)):
                if st and (not found[i] or st[-1][0] > found[i][-1][0]):
                    found[i] = st
    return [tuple(s[2] for s in st) for st in found]


def _custom_op_owners(work: List[dict], how: List[Optional[str]],
                      ops: List[dict]) -> Dict[int, dict]:
    """Device work left unlinked around K1's and K2's kernels: on each
    stream linked work splits the unlinked into runs, and the j-th run
    that holds kernels of one family belongs, whole, to the j-th call of
    that family's custom op; a family whose runs and calls do not pair up
    stays unlinked."""
    streams = defaultdict(list)
    for i, e in enumerate(work):
        streams[(e.get("pid"), e["tid"])].append(i)
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


def program_spans(events: List[dict]) -> Program:
    """The program's spans in the window of one profile's Chrome trace
    events (one ``portbench.window`` span)."""
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    windows = [(e["ts"], e["ts"] + e["dur"]) for e in spans
               if e["name"] == WINDOW and e.get("cat") in HOST_ACTIVITIES]
    if len(windows) != 1:
        raise RuntimeError(f"expected one {WINDOW} span, found "
                           f"{len(windows)}")
    w0, w1 = windows[0]
    mine = [e for e in spans if e.get("cat") == "user_annotation"
            and e["name"] in PROGRAM]
    ops = [e for e in spans if e.get("cat") == "cpu_op"]
    by_ext = {e["args"]["External id"]: e for e in spans
              if e.get("cat") in ("cpu_op", "user_annotation")
              and e.get("args", {}).get("External id")}
    by_corr = {e["args"]["correlation"]: e for e in spans
               if e.get("cat") in RUNTIME_ACTIVITIES
               and "correlation" in e.get("args", {})}
    work = [e for e in spans if e.get("cat") in DEVICE_ACTIVITIES]
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
    stacks = dict(zip(found, open_spans(
        mine, [(launchers[i]["tid"],
                launchers[i]["ts"] + launchers[i]["dur"] / 2)
               for i in found])))
    clipped, counts = [], defaultdict(int)
    for i, e in enumerate(work):
        s, t = max(e["ts"], w0), min(e["ts"] + e["dur"], w1)
        if t <= s:
            continue
        clipped.append((s, t - s, stacks.get(i, ())))
        counts[how[i] or "none"] += 1
    return Program(ops=clipped, host=_host(spans, mine, w0, w1),
                   how=dict(counts))


def _host(spans: List[dict], mine: List[dict], w0: float, w1: float
          ) -> Dict[str, List[float]]:
    """Seconds of each program span in the window less the runtime and
    driver calls on its thread."""
    runtime = defaultdict(list)
    for e in spans:
        if e.get("cat") in RUNTIME_ACTIVITIES:
            runtime[e["tid"]].append((e["ts"], e["ts"] + e["dur"]))
    index = {}
    for tid, iv in runtime.items():
        merged = _merge(iv)
        sums = [0.0]
        for a, b in merged:
            sums.append(sums[-1] + b - a)
        index[tid] = (merged, [a for a, _ in merged], sums)
    host = defaultdict(list)
    for e in sorted(mine, key=lambda e: e["ts"]):
        s, t = e["ts"], e["ts"] + e["dur"]
        if t <= w0 or s >= w1:
            continue
        waits = (_covered(*index[e["tid"]], s, t) if e["tid"] in index
                 else 0.0)
        host[e["name"]].append((t - s - waits) / 1e6)
    return dict(host)


def kineto_tuples(events: List[dict]):
    """The (name, category, start_us, duration_us, thread) that
    portbench/trace.py's ``_kineto_events`` reads from the same Chrome
    trace events."""
    for e in events:
        cat = e.get("cat", "")
        if e.get("ph") != "X" or cat not in DEVICE_ACTIVITIES + \
                HOST_ACTIVITIES:
            continue
        yield (e["name"], cat, float(e["ts"]), float(e.get("dur", 0.0)),
               e.get("tid"))


class SpanTracer(Tracer):
    """portbench/trace.py's traced window (the same profile, window span
    and ``parse``), which also reads the program's spans (``program``)."""

    def __init__(self):
        super().__init__(True)
        self.program: Optional[Program] = None

    @contextlib.contextmanager
    def window(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.__enter__()
        try:
            with torch.profiler.record_function(WINDOW):
                yield
        finally:
            prof.__exit__(None, None, None)
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        self.trace = parse(list(kineto_tuples(events)))
        self.program = program_spans(events)


def reading(name: str, kind: str, program: Program, driver
            ) -> Optional[float]:
    """One of ``READINGS``: ms a call of a span's host time, or device ms
    an image; None where the span is absent from the window."""
    span, what = READINGS[kind][name]
    if what == "host":
        host = program.host.get(span)
        return 1e3 * sum(host) / len(host) if host else None
    seconds = program.device_seconds(span)
    n = driver.traced_images
    return 1e3 * seconds / n if seconds and n else None


def run(root: str, workload: str, seed: int, seconds: float,
        device="cuda") -> Dict:
    """One traced window of a cell and its program spans."""
    _, cell, config, traffic = load_cell(root, workload)
    kind = traffic["driver"]
    driver = drivers.load(kind)(config, traffic, seed, device)
    driver.setup()
    tracer = SpanTracer()
    driver.window(min(seconds, TRACE_SECONDS), tracer)
    driver.release()
    trace, program = tracer.trace, tracer.program
    n = driver.traced_images
    busy_us = trace.busy_s * 1e6
    launched = sorted({s for *_, st in program.ops for s in st})
    return {
        "workload": workload, "seed": seed,
        "readings": {name: reading(name, kind, program, driver)
                     for name in READINGS[kind]},
        "span_device_ms": {s: 1e3 * program.device_seconds(s) / n
                           for s in launched if n},
        "span_host_ms": {s: 1e3 * sum(v) / len(v)
                         for s, v in program.host.items()},
        "span_calls": {s: len(v) for s, v in program.host.items()},
        "cover": {k: 100.0 * program.device_seconds(*names) * 1e6 / busy_us
                  for k, names in COVER[kind].items() if busy_us},
        "outside_ms": (sum(d for _, d, st in program.ops if not st) / 1e3
                       / n if n else None),
        "busy_ms": 1e3 * trace.busy_s / n if n else None,
        "linked": program.how,
        "busy_s": trace.busy_s, "window_s": trace.window_s,
        "idle_share": 100.0 * (1.0 - trace.busy_s / trace.window_s),
        "end_to_end": driver.end_to_end(),
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    args = parser.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    out = run(ROOT, args.workload, args.seed, args.seconds)
    out["device"] = torch.cuda.get_device_name()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
