"""Running metrics (reference yolo/util/metric.py:11-27) and the JSONL
scalar log: the JAX package's utils/metrics.py AverageMeter and
MetricsJSONL."""

from __future__ import annotations


class AverageMeter:
    """Tracks current value, running sum, count and mean."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1) -> None:
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count


class MetricsJSONL:
    """Append-only JSONL scalar sink (the JAX package's utils/metrics.py):
    one line per record, {"ts": unix_seconds, **record}, flushed at once so
    that a crash loses nothing. The stdout log stays; this is its
    machine-readable copy. Disabled (every rank but 0), it writes nothing
    and creates no directory."""

    def __init__(self, path: str, enabled: bool = True):
        import os
        self.path = path
        self.enabled = enabled
        if enabled:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def write(self, record: dict) -> None:
        if not self.enabled:
            return
        import json
        import time
        with open(self.path, "a") as f:
            f.write(json.dumps({"ts": round(time.time(), 3), **record},
                               default=float) + "\n")
