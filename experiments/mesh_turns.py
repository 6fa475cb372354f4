"""Time a mesh Predictor's batch with its replica threads taking turns
(parallel/mesh.ReplicaGroup, the port's design) against two other ways of
running them, beside one replica: the design comparison behind
``ReplicaGroup`` (PERF.md §6). It lives outside the package:
``AtOnceGroup`` is no policy the port offers.

Usage (on a machine with a CUDA card):

    python experiments/mesh_turns.py [--replicas 2] [--rounds 2]
        [--quant none int8]

The full-width detector at 608, batch 16, bfloat16, ``PALLAS_CSP`` on, the
seed-0 init, the cfg's thresholds, on ``--replicas`` replicas of cuda:0 (global batch
16) and alone, for each ``--quant`` mode (``int8`` is span full: a
``replica_max`` at each of its int8 sites). Each way is timed on one host
batch's ``dispatch``: ms between CUDA events (the host's enqueue
included), device ms with a spin kernel queued ahead, and host ms of the
call alone:

  one            one replica at b16
  turns          the mesh, its lasting threads taking turns
  at_once        the mesh, its threads running at once and meeting at a
                 barrier at each replica_max (``AtOnceGroup``, put in
                 place of parallel/mesh.ReplicaGroup for the run)
  fresh_threads  the mesh in turns, with new threads for every batch

The ways take turns, in reverse order every other round. Prints a line per
way and round, then the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from yolov4_tpu_torch.config import Config  # noqa: E402
from yolov4_tpu_torch.engine.predictor import Predictor  # noqa: E402
from yolov4_tpu_torch.parallel import mesh as mesh_mod  # noqa: E402
from yolov4_tpu_torch.parallel.mesh import (  # noqa: E402
    TURN_TIMEOUT_S, ReplicaGroup, ReplicaRunner, create_mesh)

WAYS = ("one", "turns", "at_once", "fresh_threads")
# a spin of ~150 ms queued ahead of a call, longer than its enqueue
SPIN_CYCLES = 300_000_000


class AtOnceGroup(ReplicaGroup):
    """The replicas run at once and meet at a barrier at each
    ``replica_max``, instead of taking turns."""

    def __init__(self, mesh, streams=None):
        super().__init__(mesh, streams)
        self._barrier = threading.Barrier(mesh.size, timeout=TURN_TIMEOUT_S)

    def start(self, rank: int) -> None:
        pass

    def finish(self, rank: int) -> None:
        pass

    def fail(self) -> None:
        self._barrier.abort()

    def _meet(self, rank: int, call: int, slots: list, mine: tuple) -> None:
        # a replica is at most one call ahead of another: the slots of
        # this call are not written again before every replica has passed
        # the next barrier, after reading them
        slots[rank] = mine
        self._barrier.wait()


@contextlib.contextmanager
def at_once():
    """Mesh runs inside the block use ``AtOnceGroup``."""
    mesh_mod.ReplicaGroup = AtOnceGroup
    try:
        yield
    finally:
        mesh_mod.ReplicaGroup = ReplicaGroup


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--replicas", type=int, default=2)
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--quant", nargs="+", default=["none", "int8"],
                        choices=("none", "int8"))
    return parser.parse_args(argv)


def times(pred, images, iters=10, warmup=3) -> dict:
    """Median ms of one ``dispatch``: between CUDA events, behind a spin
    kernel (device), and on the host clock alone."""
    out = {}
    for key, spin in (("ms", False), ("device_ms", True)):
        for _ in range(warmup):
            pred.dispatch(images)
        torch.cuda.synchronize()
        runs = []
        for _ in range(iters):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            if spin:
                torch.cuda._sleep(SPIN_CYCLES)
            start.record()
            pred.dispatch(images)
            end.record()
            torch.cuda.synchronize()
            runs.append(start.elapsed_time(end))
        out[key] = float(np.median(runs))
    runs = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pred.dispatch(images)
        runs.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    out["host_ms"] = float(np.median(runs))
    return out


def run_way(way: str, one: Predictor, mesh: Predictor, images) -> dict:
    if way == "one":
        return times(one, images)
    if way == "fresh_threads":
        dispatch = mesh.dispatch

        def fresh(batch):
            mesh._runner = ReplicaRunner(mesh.mesh)
            return dispatch(batch)

        mesh.dispatch = fresh
        try:
            return times(mesh, images)
        finally:
            del mesh.dispatch
    with (at_once() if way == "at_once" else contextlib.nullcontext()):
        return times(mesh, images)


def main(argv=None) -> dict:
    args = parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("mesh_turns: no CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    images = np.random.default_rng(43).integers(0, 256, (16, 608, 608, 3),
                                                dtype=np.uint8)
    result = {"card": smi, "replicas": args.replicas, "rows": []}
    for quant in args.quant:
        model = {"PALLAS_CSP": True}
        if quant == "int8":
            model.update(QUANT="int8", QUANT_SPAN="full")
        cfg = Config.from_dict({"MODEL": model})
        one = Predictor(cfg, img_size=608, batch_size=16, device="cuda")
        mesh = Predictor(cfg, model=one.model, img_size=608, batch_size=16,
                         mesh=create_mesh(["cuda:0"] * args.replicas))
        one.warmup()
        mesh.warmup()
        for r in range(args.rounds):
            for way in (WAYS if r % 2 == 0 else WAYS[::-1]):
                row = dict(quant=quant, round=r, way=way,
                           **run_way(way, one, mesh, images))
                result["rows"].append(row)
                print(json.dumps(row), flush=True)
        # the ways run one program: the same rows in turns and at once
        turns = mesh(images)
        with at_once():
            together = mesh(images)
        if not (turns[1].any() and all(np.array_equal(a, b)
                                       for a, b in zip(turns, together))):
            raise AssertionError(f"{quant}: the mesh's rows in turns and at "
                                 "once differ, or there are none")
        del one, mesh
        torch.cuda.empty_cache()
    print(smi)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
