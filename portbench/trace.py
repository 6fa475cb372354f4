"""The traced run's profiler window and what is read from it.

``Tracer`` wraps ``torch.profiler`` (host and CUDA activities) around the
measured window, marked by a ``portbench.window`` span, and the
benchmark's own spans (``portbench.dispatch``, ``portbench.fetch``,
``portbench.step``). ``Trace`` holds what the per-layer readers need:
every device operation clipped to the window, the union of their
intervals (busy time), the longest idle gaps named by what the host was
doing when each began, and each of the benchmark's spans with its host
time outside CUDA runtime and driver calls (where the host waits: on a
full launch queue, a synchronize, a pinned allocation). Timestamps are
the profiler's, in microseconds.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

WINDOW = "portbench.window"


@dataclass
class Trace:
    window_s: float
    busy_s: float
    # (name, start_us, duration_us) of every device operation in the window
    device_ops: List[Tuple[str, float, float]]
    # the longest idle gaps: (what the host was doing, seconds)
    idle_gaps: List[Tuple[str, float]]
    # host spans of the benchmark itself: name -> durations in seconds
    spans: Dict[str, List[float]] = field(default_factory=dict)
    # the same spans' seconds outside CUDA runtime and driver calls on
    # their thread
    span_host: Dict[str, List[float]] = field(default_factory=dict)

    def device_seconds(self, *parts: str) -> float:
        """Device seconds of the operations whose name holds any of
        ``parts`` (all operations when none is given)."""
        return sum(d for n, _, d in self.device_ops
                   if not parts or any(p in n for p in parts)) / 1e6

    def top_ops(self, n: int = 10) -> List[Tuple[str, float]]:
        total = defaultdict(float)
        for name, _, d in self.device_ops:
            total[name] += d / 1e6
        return sorted(total.items(), key=lambda kv: -kv[1])[:n]


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float,
                                                               float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _covered(merged: List[Tuple[float, float]], starts: List[float],
             ends_sum: List[float], s: float, e: float) -> float:
    """The length of [s, e) covered by ``merged`` (disjoint, sorted
    intervals; ``starts`` their starts, ``ends_sum`` the running sum of
    their lengths)."""
    i = bisect.bisect_right(starts, s)
    j = bisect.bisect_left(starts, e)
    total = ends_sum[j] - ends_sum[i]
    if i > 0:                       # the interval begun before s
        a, b = merged[i - 1]
        total += max(0.0, min(b, e) - s)
    if j > i:                       # the last one may run past e
        a, b = merged[j - 1]
        total -= max(0.0, b - e)
    return total


def parse(events, n_gaps: int = 10) -> Trace:
    """``events``: (name, category, start_us, duration_us, thread) of one
    profile holding one ``portbench.window`` span."""
    windows = [(s, s + d) for n, cat, s, d, _ in events
               if n == WINDOW and cat not in DEVICE_ACTIVITIES]
    if len(windows) != 1:
        raise RuntimeError(f"expected one {WINDOW} span, found "
                           f"{len(windows)}")
    w0, w1 = windows[0]
    ops, host, spans = [], [], defaultdict(list)
    mine, runtime = [], defaultdict(list)
    for name, cat, s, d, tid in events:
        e = s + d
        if e <= w0 or s >= w1:
            continue
        if cat in DEVICE_ACTIVITIES:
            s, e = max(s, w0), min(e, w1)
            ops.append((name, s, e - s))
        elif name != WINDOW:
            host.append((s, e, name))
            if cat in RUNTIME_ACTIVITIES:
                runtime[tid].append((s, e))
            if name.startswith("portbench."):
                spans[name].append(d / 1e6)
                mine.append((name, s, e, tid))
    span_host = defaultdict(list)
    merged = {tid: _merge(iv) for tid, iv in runtime.items()}
    index = {}
    for tid, iv in merged.items():
        sums = [0.0]
        for a, b in iv:
            sums.append(sums[-1] + b - a)
        index[tid] = ([a for a, _ in iv], sums)
    for name, s, e, tid in mine:
        waits = (_covered(merged[tid], *index[tid], s, e)
                 if tid in merged else 0.0)
        span_host[name].append((e - s - waits) / 1e6)
    busy = _merge([(s, s + d) for _, s, d in ops])
    edges = [w0] + [t for iv in busy for t in iv] + [w1]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i])
                   for i in range(0, len(edges) - 1, 2)
                   if edges[i + 1] > edges[i]), reverse=True)[:n_gaps]
    host.sort()
    named = []
    for length, start in gaps:
        t = start + min(1.0, length / 2)
        # the innermost host event running when the gap began
        inner = [(s, name) for s, e, name in host if s <= t < e]
        named.append((max(inner)[1] if inner else "idle host",
                      length / 1e6))
    return Trace(window_s=(w1 - w0) / 1e6,
                 busy_s=sum(e - s for s, e in busy) / 1e6,
                 device_ops=ops, idle_gaps=named, spans=dict(spans),
                 span_host=dict(span_host))


class Tracer:
    """``with tracer.window(): ...`` around the measured loop, and
    ``tracer.span(name)`` around each call into the program. Off, it only
    times the window."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.trace: Optional[Trace] = None

    def span(self, name: str):
        if not self.enabled:
            return contextlib.nullcontext()
        import torch
        return torch.profiler.record_function(name)

    @contextlib.contextmanager
    def window(self):
        if not self.enabled:
            yield
            return
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
        t = time.perf_counter()
        self.trace = parse(list(_kineto_events(prof)))
        self.parse_s = time.perf_counter() - t


# activities that occupy the device; a record_function range also shows on
# the device timeline ("gpu_user_annotation") and is left out
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_ACTIVITIES = ("cuda_runtime", "cuda_driver")
HOST_ACTIVITIES = ("cpu_op", "user_annotation") + RUNTIME_ACTIVITIES


def _kineto_events(prof):
    """(name, category, start_us, duration_us, thread) of a finished
    profile, read from its Chrome trace (written to a temporary directory
    and removed): the categories there name each event's activity in every
    PyTorch version."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    for e in events:
        cat = e.get("cat", "")
        if e.get("ph") != "X" or cat not in DEVICE_ACTIVITIES + \
                HOST_ACTIVITIES:
            continue
        yield (e["name"], cat, float(e["ts"]), float(e.get("dur", 0.0)),
               e.get("tid"))
