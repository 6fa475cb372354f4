"""A ``torch.profiler`` window over training steps (the JAX package's
utils/profiling.py StepProfiler, for ``--profile N``).

The trace covers steps [start, start + count) and is written as a Chrome
trace (``trace.json``) plus a ``kernels.txt`` table of the device kernels
by total time into ``logdir``.
"""

from __future__ import annotations

import os

import torch


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
        prof.export_chrome_trace(os.path.join(self.logdir, "trace.json"))
        sort = ("self_cuda_time_total" if torch.cuda.is_available()
                else "self_cpu_time_total")
        with open(os.path.join(self.logdir, "kernels.txt"), "w") as f:
            f.write(prof.key_averages().table(sort_by=sort, row_limit=60))
