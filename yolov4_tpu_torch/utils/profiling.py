"""The program's spans, their reading from a profile, and a
``torch.profiler`` window over training steps (the JAX package's
utils/profiling.py StepProfiler, for ``--profile N``).

``span(name)`` marks one of the program's layer boundaries (``SPANS``):
``Predictor`` upload and program, the model's backbone, neck and head,
the postprocess, and the train step's forward, loss, backward and update.
While a ``torch.profiler`` records, it is a ``record_function`` range, in
the profiler's own trace beside the work it launched; otherwise, and
while ``torch.export`` traces, it is one shared no-op.

``attribute`` puts each unit of a profile's work (on CUDA each device
activity, on the CPU each CPU op's self time) down to the scopes open
around the host event that launched it; ``span_host`` gives each span's
host time outside CUDA runtime and driver calls, where the host waits on
the card.

StepProfiler's trace covers steps [start, start + count) and is written
into ``logdir`` as a Chrome trace (``trace.json``), a ``kernels.txt``
table of the device kernels by total time and a ``spans.txt`` table of
the device and host milliseconds of each program span.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import torch

# the program's spans, from the entry points down
SPANS = ("predictor.upload", "predictor.program", "model.backbone",
         "model.neck", "model.head", "postprocess", "train.forward",
         "train.loss", "train.backward", "train.update")
NOOP = contextlib.nullcontext()

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
# K1's and K2's kernels (by name prefix) and the custom op that launches them
CUSTOM_OPS = (("nms_", "yolov4_tpu_torch::greedy_nms_mask"),
              ("csp_", "yolov4_tpu_torch::fused_csp_stage"))
UNATTRIBUTED = "(unattributed)"


def span(name: str):
    """A ``record_function`` range named ``name`` while a profiler
    records (and no ``torch.export`` traces); the shared no-op else."""
    if not torch.autograd._profiler_enabled() or \
            torch.compiler.is_compiling():
        return NOOP
    return torch.profiler.record_function(name)


def chrome_events(prof, path: Optional[str] = None) -> List[dict]:
    """The events of a finished profile's Chrome trace, written to
    ``path`` (kept) or to a temporary directory."""
    with tempfile.TemporaryDirectory() as tmp:
        path = path or os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]


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


def open_scopes(spans: List[dict], queries: List[tuple]
                ) -> List[Tuple[str, ...]]:
    """For each query (tid, t), the names of the spans open at time t on
    thread tid, outermost first. Where that thread has none open, those
    open at t on the thread whose innermost open span began last: the
    backward's launches come from autograd's device thread while the
    caller's thread holds its span."""
    by_tid = defaultdict(list)
    for s in spans:
        by_tid[s["tid"]].append((s["ts"], s["ts"] + s["dur"], s["name"]))
    per_tid = defaultdict(list)
    for i, (tid, t) in enumerate(queries):
        per_tid[tid].append(i)
    found: List[tuple] = [()] * len(queries)
    for tid, idx in per_tid.items():
        for i, st in zip(idx, _sweep(by_tid.get(tid, []),
                                     [queries[i][1] for i in idx])):
            found[i] = st
    empty = [i for i, st in enumerate(found) if not st]
    if empty and by_tid:
        times = [queries[i][1] for i in empty]
        for tid_spans in by_tid.values():
            for i, st in zip(empty, _sweep(tid_spans, times)):
                if st and (not found[i] or st[-1][0] > found[i][-1][0]):
                    found[i] = st
    return [tuple(s[2] for s in st) for st in found]


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
    """Each unit of work of the trace with its scopes: on CUDA each device
    activity, found by its launch (the CPU op of its "External id", else
    the runtime call of its "correlation", else, for K1's and K2's
    kernels, which launch through ``ctypes``, the call of their custom op
    in the same place of the order of such calls); on the CPU each CPU
    op's self time. Returns [{name, op, ts, us, scope, scopes, how}]:
    ``scopes`` the names of ``scope_names`` open around the launch
    (``open_scopes``), ``scope`` the innermost (UNATTRIBUTED where none
    is), ``how`` the link ("op", "runtime", "custom_op"; None where no
    scope was found)."""
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
               if e.get("cat") in RUNTIME_CATS
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
    stacks = dict(zip(found, open_scopes(
        scopes, [(launchers[i]["tid"], _mid(launchers[i])) for i in found])))
    rows = []
    for i, e in enumerate(work):
        st = stacks.get(i, ())
        rows.append(dict(name=e["name"], ts=float(e["ts"]),
                         us=float(e["dur"]),
                         op=launchers[i]["name"] if launchers[i] else None,
                         scope=st[-1] if st else UNATTRIBUTED, scopes=st,
                         how=how[i] if st else None))
    return rows


def _attribute_cpu(ops: List[dict], scopes: List[dict]) -> List[dict]:
    """Each CPU op's self time (its time less its child ops') in the
    scopes around it."""
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
    stacks = open_scopes(scopes, [(e["tid"], _mid(e)) for e in ops])
    return [dict(name=e["name"], op=e["name"], ts=float(e["ts"]),
                 us=max(us, 0.0), scope=st[-1] if st else UNATTRIBUTED,
                 scopes=st, how="op" if st else None)
            for e, us, st in zip(ops, self_us, stacks)]


def span_host(events: Sequence[dict], names: Sequence[str]
              ) -> Dict[str, List[float]]:
    """Each occurrence of the spans ``names``: its host microseconds less
    the CUDA runtime and driver calls on its thread."""
    runtime = defaultdict(list)
    mine = []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        if e.get("cat") in RUNTIME_CATS:
            runtime[e["tid"]].append((e["ts"], e["ts"] + e["dur"]))
        elif e.get("cat") == "user_annotation" and e["name"] in names:
            mine.append(e)
    merged = {}
    for tid, iv in runtime.items():
        out: List[List[float]] = []
        for s, t in sorted(iv):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], t)
            else:
                out.append([s, t])
        merged[tid] = (out, [b for _, b in out])
    host = defaultdict(list)
    for e in sorted(mine, key=lambda e: e["ts"]):
        s, t = e["ts"], e["ts"] + e["dur"]
        iv, ends = merged.get(e["tid"], ([], []))
        i = bisect.bisect_left(ends, s)
        waits = 0.0
        while i < len(iv) and iv[i][0] < t:
            waits += min(iv[i][1], t) - max(iv[i][0], s)
            i += 1
        host[e["name"]].append(float(e["dur"]) - waits)
    return dict(host)


def span_table(events: Sequence[dict], device: str,
               names: Sequence[str] = SPANS) -> Dict[str, Dict]:
    """Each span of ``names`` in the trace: its calls, the device (on the
    CPU: CPU op self) milliseconds of the work launched inside it, child
    spans included, and its host milliseconds outside runtime calls; and
    under "(all)" the whole trace's work."""
    rows = attribute(events, set(names), device)
    host = span_host(events, names)
    table = {}
    for name in names:
        if name not in host:
            continue
        table[name] = dict(
            calls=len(host[name]), host_ms=sum(host[name]) / 1e3,
            work_ms=sum(r["us"] for r in rows if name in r["scopes"]) / 1e3)
    table["(all)"] = dict(calls=0, host_ms=0.0,
                          work_ms=sum(r["us"] for r in rows) / 1e3)
    return table


def format_span_table(table: Dict[str, Dict], device: str) -> str:
    work = "device ms" if device == "cuda" else "cpu op ms"
    lines = [f"{'span':20s} {'calls':>6s} {work:>12s} {'host ms':>12s}"]
    total = table["(all)"]["work_ms"]
    for name, row in table.items():
        share = f"  {100 * row['work_ms'] / total:5.1f}%" if total else ""
        lines.append(f"{name:20s} {row['calls']:6d} {row['work_ms']:12.3f} "
                     f"{row['host_ms']:12.3f}{share}")
    return "\n".join(lines) + "\n"


class StepProfiler:
    """Capture a trace window covering steps [start, start + count)."""

    def __init__(self, logdir: str, start: int = 10, count: int = 0):
        self.logdir = logdir
        self.start = start
        self.count = count
        self._prof = None

    def on_step(self, step: int) -> None:
        """Call after each step with the 1-based count of steps taken."""
        if self.count <= 0:
            return
        if self._prof is None and step == self.start:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=activities)
            self._prof.__enter__()
        elif self._prof is not None and step >= self.start + self.count:
            self.close()

    def close(self) -> None:
        if self._prof is None:
            return
        prof, self._prof = self._prof, None
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        os.makedirs(self.logdir, exist_ok=True)
        events = chrome_events(prof, os.path.join(self.logdir, "trace.json"))
        # the steps ran on a card when the trace holds its activities
        device = ("cuda" if any(e.get("cat") in DEVICE_CATS for e in events)
                  else "cpu")
        sort = ("self_cuda_time_total" if device == "cuda"
                else "self_cpu_time_total")
        with open(os.path.join(self.logdir, "kernels.txt"), "w") as f:
            f.write(prof.key_averages().table(sort_by=sort, row_limit=60))
        with open(os.path.join(self.logdir, "spans.txt"), "w") as f:
            f.write(format_span_table(span_table(events, device), device))
