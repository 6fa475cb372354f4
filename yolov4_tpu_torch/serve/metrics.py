"""Serving metrics: thread-safe counters + latency quantiles.

The port's copy of the JAX package's serve/metrics.py. The reference has
no serving story (its closest analogue is detect.py's one-shot CLI loop);
a deployment needs observable queue / batch / latency behaviour. Kept
dependency-free: counters and bounded latency reservoirs under one lock,
rendered either as JSON-able dicts or Prometheus text exposition format
(``render_prometheus``).
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Dict, List

import numpy as np

_QUANTILES = (0.5, 0.9, 0.99)


class _Reservoir:
    """Bounded sliding window of observations (most recent N)."""

    def __init__(self, maxlen: int = 4096):
        self.window = deque(maxlen=maxlen)
        self.count = 0
        self.total = 0.0

    def observe(self, value: float) -> None:
        self.window.append(value)
        self.count += 1
        self.total += value

    def snapshot(self) -> Dict[str, float]:
        out = {"count": self.count, "sum": self.total}
        if self.window:
            arr = np.fromiter(self.window, np.float64)
            for q in _QUANTILES:
                out[f"p{int(q * 100)}"] = float(np.quantile(arr, q))
            out["mean_window"] = float(arr.mean())
        return out


class ServeMetrics:
    """All mutation goes through one lock; scrapes take a consistent copy."""

    def __init__(self):
        self._lock = threading.Lock()
        self.counters: Dict[str, int] = {
            "requests_total": 0,
            "detections_total": 0,
            "errors_total": 0,
            "batches_total": 0,
            "batch_rows_total": 0,   # occupancy = rows / (batches * size)
        }
        self.latency = {
            "e2e_ms": _Reservoir(),      # submit -> result ready
            "queue_ms": _Reservoir(),    # submit -> batch assembled
            "batch_ms": _Reservoir(),    # dispatch -> outputs fetched
            "batch_fill": _Reservoir(),  # rows / batch_size per batch
        }

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def observe(self, name: str, value: float) -> None:
        with self._lock:
            self.latency[name].observe(value)

    def snapshot(self) -> Dict:
        with self._lock:
            return {
                "counters": dict(self.counters),
                "latency": {k: v.snapshot() for k, v in self.latency.items()},
            }

    def render_prometheus(self, extra_gauges: Dict[str, float] = None) -> str:
        snap = self.snapshot()
        lines: List[str] = []
        for name, val in sorted(snap["counters"].items()):
            metric = f"yolov4_serve_{name}"
            lines.append(f"# TYPE {metric} counter")
            lines.append(f"{metric} {val}")
        for name, stats in sorted(snap["latency"].items()):
            metric = f"yolov4_serve_{name}"
            lines.append(f"# TYPE {metric} summary")
            for q in _QUANTILES:
                key = f"p{int(q * 100)}"
                if key in stats:
                    lines.append(f'{metric}{{quantile="{q}"}} {stats[key]:.6g}')
            lines.append(f"{metric}_sum {stats['sum']:.6g}")
            lines.append(f"{metric}_count {stats['count']}")
        for name, val in sorted((extra_gauges or {}).items()):
            metric = f"yolov4_serve_{name}"
            lines.append(f"# TYPE {metric} gauge")
            lines.append(f"{metric} {val:.6g}")
        return "\n".join(lines) + "\n"
