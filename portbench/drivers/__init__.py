"""The general generator: one driver per kind of traffic, found by name.

A traffic file (``portbench/traffic/<traffic>.json``) names its driver,
``"driver": "<name>"``, the module ``portbench/drivers/<name>.py``, whose
``Driver`` class runs every traffic file that names it, parameterized by
that file and by the configuration file the cell names. A new kind of
traffic is a new module here; a new size of a kind is a new data file.

A driver builds the program through its public entry points with the
settings its CLIs use, makes the weights and inputs from the seed on the
device (portbench/weights.py), warms the cell's own shapes, drives the
measured window, and then, with the program's state freed, computes the
reference's answers and the numbers of portbench/check.py. It returns its
own end-to-end values (``end_to_end``); the harness adds ``setup_s``.

``wrap`` (tests and portbench/readings.py only) wraps the program's call
(dispatch or step) to plant a fault in the timed path.
"""

from __future__ import annotations

import importlib
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch


def load(name: str) -> type:
    """The ``Driver`` class of ``portbench/drivers/<name>.py``."""
    return importlib.import_module(f"portbench.drivers.{name}").Driver


def program_cfg(config: Dict, traffic: Dict):
    """The program's config: the configuration file's settings, then the
    traffic's."""
    from yolov4_tpu_torch.config import Config
    cfg = Config.from_dict(config.get("cfg", {}))
    for section, values in traffic.get("cfg", {}).items():
        cfg[section].update(values)
    cfg.validate()
    return cfg


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Driver:
    """What every kind shares: the seed, the device, the set-up clock, and
    the counts the per-layer readers take (portbench/metrics/)."""

    # the end-to-end rate this kind reports: work items over the window
    RATE = ""
    # the faults of portbench/faults.py that this kind's timed path can have
    FAULTS: Tuple[str, ...] = ()
    # the traffic's sizes cut for a whole run on the CPU (portbench/tests)
    SMALL: Dict = {}

    def __init__(self, config: Dict, traffic: Dict, seed: int, device,
                 wrap: Optional[Callable] = None):
        self.config, self.traffic, self.seed = config, traffic, int(seed)
        self.device = torch.device(device)
        self.wrap = wrap or (lambda fn: fn)
        self.setup_parts: Dict[str, float] = {}
        self.attempted = 0
        self.work = 0              # images completed in the window
        self.window_s = 0.0
        self.traced_images = 0     # images whose device work the window holds
        self.forwards = 0          # detection forwards the window holds

    def _part(self, name: str, t0: float) -> float:
        sync(self.device)
        t = time.perf_counter()
        self.setup_parts[name] = self.setup_parts.get(name, 0.0) + t - t0
        return t

    def end_to_end(self) -> Dict[str, float]:
        """This kind's end-to-end values but ``setup_s``, by metric name."""
        return {self.RATE: self.work / self.window_s}

    def setup(self) -> None:
        raise NotImplementedError

    def window(self, seconds: float, tracer) -> None:
        raise NotImplementedError

    def release(self) -> None:
        raise NotImplementedError

    def check(self) -> Dict[str, List[float]]:
        """The numbers the limits compare, as lists over the checked items
        (images, or one item for a number pooled over them)."""
        raise NotImplementedError

    def readings(self, seconds: float) -> Dict:
        """The check's numbers of one seed, as a run computes them, after a
        window of ``seconds`` (portbench/readings.py)."""
        raise NotImplementedError

    def control(self, seconds: float) -> Dict:
        """The same numbers of the control: the reference's computation in
        the nearest precision below the configuration's, or the program's
        own path in it."""
        raise NotImplementedError
