"""Single-process meshes of replicas: the port's counterpart of the JAX
package's parallel/mesh.py (``create_mesh``, ``batch_sharding``,
``replicated``).

In the JAX package a mesh predictor is one program that GSPMD partitions
over the mesh's 'data' axis: the batch is sharded, the weights are
replicated, and every batch-global reduction of the program (the NMS's
class-offset span, the dynamic int8 activation abs-max) is still taken
over the whole batch. The port runs that program once per replica, each
in a host thread of its own on its own CUDA stream (``ReplicaRunner``), on
a contiguous block of rows (``Mesh.shards``, as ``P('data')``), and takes
those reductions across the replicas with ops/replica.py's
``replica_max``.

In a mesh run ``replica_max`` puts each replica's value (a 0-d tensor on
its device) beside the others' and hands the turn on; once every replica
has put its value there, each takes the max of all of them on its own
device, its stream waiting on an event recorded after each other
replica's value (``ReplicaGroup.all_max``). The host waits only for the
other threads to have enqueued their values, never for the device. The
replica threads take turns on the host (``ReplicaGroup``); their streams
run side by side on the device.
"""

from __future__ import annotations

import functools
import queue
import threading
import weakref
from contextlib import ExitStack
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from yolov4_tpu_torch.ops.replica import replica_scope
from yolov4_tpu_torch.utils.device import device_scope, resolve_device

# a replica that waits this long for its turn fails the run
TURN_TIMEOUT_S = 900.0


@dataclass(frozen=True)
class Mesh:
    """The replicas of a single-process mesh, in mesh order. A device may
    appear more than once: two replicas on one card run on two streams."""

    devices: Tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def distinct_devices(self) -> Tuple[torch.device, ...]:
        """Each device once, in mesh order (one copy of the weights
        each)."""
        return tuple(dict.fromkeys(self.devices))

    def round_batch(self, batch_size: int) -> int:
        """``batch_size`` rounded up to a whole number of rows per
        replica."""
        return -(-batch_size // self.size) * self.size

    def shards(self, batch_size: int) -> List[slice]:
        """Each replica's rows of a batch: contiguous blocks in mesh order
        (the JAX package's ``batch_sharding``, ``P('data')``)."""
        if batch_size % self.size:
            raise ValueError(f"batch {batch_size} does not split over "
                             f"{self.size} replicas")
        rows = batch_size // self.size
        return [slice(i * rows, (i + 1) * rows) for i in range(self.size)]


def create_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """A mesh over ``devices`` (names or ``torch.device``s; the CPU and
    repeats allowed, all of one type), or over every local CUDA card.
    Without CUDA the default raises, as ``resolve_device`` does: nothing
    falls back to the CPU."""
    if devices is None:
        resolve_device("cuda")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    resolved = []
    for d in devices:
        d = resolve_device(d)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        resolved.append(d)
    if not resolved:
        raise ValueError("a mesh needs at least one device")
    if len({d.type for d in resolved}) > 1:
        raise ValueError(f"a mesh's devices must be of one type: {resolved}")
    return Mesh(tuple(resolved))


class ReplicaError(RuntimeError):
    """A replica of a mesh run could not go on: another failed, or the
    replicas did not meet at ``replica_max``."""


class ReplicaGroup:
    """The replicas of one ``ReplicaRunner.run`` and the slots of
    ``replica_max``. The replicas take turns on the host, in rank order:
    one runs (enqueues its work) while the others wait, and it hands the
    turn on at each ``replica_max`` and when it ends. Running them all at
    once would gain nothing under the interpreter lock and would lose much
    to handing it between threads at every operation; the device still
    runs the replicas' streams side by side. Slots alternate between two
    sets: in turn order no replica is more than one call ahead of another,
    and each has read a set before any writes it again."""

    def __init__(self, mesh: Mesh, streams: Optional[Sequence] = None):
        self.mesh = mesh
        self.streams = streams
        self._cond = threading.Condition()
        self._turn = 0
        self._done = [False] * mesh.size
        self._failed = False
        # slot: (call index, the value's copies on each replica's device,
        # the event after them or None)
        self._slots = ([None] * mesh.size, [None] * mesh.size)
        self._calls = [0] * mesh.size

    def _wait(self, ready: Callable[[], bool]) -> None:
        """Wait (holding ``_cond``) until ``ready()`` or a failure."""
        if not self._cond.wait_for(lambda: self._failed or ready(),
                                   TURN_TIMEOUT_S):
            self._failed = True
            self._cond.notify_all()
            raise ReplicaError(f"a replica waited {TURN_TIMEOUT_S:.0f} s "
                               "for its turn")
        if self._failed:
            raise ReplicaError("another replica of the mesh run failed")

    def _hand_on(self, rank: int) -> None:
        """Give the turn to the next replica that has not ended."""
        n = self.mesh.size
        for step in range(1, n + 1):
            nxt = (rank + step) % n
            if not self._done[nxt]:
                self._turn = nxt
                break
        self._cond.notify_all()

    def start(self, rank: int) -> None:
        with self._cond:
            self._wait(lambda: self._turn == rank)

    def finish(self, rank: int) -> None:
        with self._cond:
            self._done[rank] = True
            self._hand_on(rank)

    def fail(self) -> None:
        with self._cond:
            self._failed = True
            self._cond.notify_all()

    def all_max(self, rank: int, value: torch.Tensor) -> torch.Tensor:
        """The max of every replica's ``value`` (one call from each, in the
        same order), on this replica's device."""
        call = self._calls[rank]
        self._calls[rank] += 1
        slots = self._slots[call % 2]
        if self.streams is None:
            mine = (call, [value] * self.mesh.size, None)
        else:
            # on this replica's stream: copies to each replica's device,
            # then an event the readers wait on
            copies = [value.to(d, non_blocking=True)
                      for d in self.mesh.devices]
            event = torch.cuda.Event()
            event.record(self.streams[rank])
            mine = (call, copies, event)
        self._meet(rank, call, slots, mine)
        parts = []
        for peer, (_, copies, event) in enumerate(slots):
            part = copies[rank]
            if event is not None and peer != rank:
                stream = self.streams[rank]
                stream.wait_event(event)
                # the peer's allocation is read on this stream
                part.record_stream(stream)
            parts.append(part)
        return torch.stack(parts).amax()

    def _meet(self, rank: int, call: int, slots: list, mine: tuple) -> None:
        """Put ``mine`` in this replica's slot, hand the turn on, and wait
        until every replica has put its value of this call and the turn
        is back."""

        def met() -> bool:
            if any(s is None or s[0] != call for s in slots):
                if any(d and (s is None or s[0] != call)
                       for d, s in zip(self._done, slots)):
                    raise ReplicaError("the replicas called replica_max a "
                                       "different number of times")
                return False
            return self._turn == rank

        with self._cond:
            slots[rank] = mine
            self._hand_on(rank)
            try:
                self._wait(met)
            except ReplicaError:
                self._failed = True
                self._cond.notify_all()
                raise


def _serve_jobs(jobs: "queue.SimpleQueue") -> None:
    """A replica thread's loop: run each job until a None arrives."""
    while True:
        job = jobs.get()
        if job is None:
            return
        job()
        # the job holds its caller (a predictor) until the next one comes
        del job


def _stop_threads(queues) -> None:
    for jobs in queues:
        jobs.put(None)


class ReplicaRunner:
    """Runs a function once per replica of ``mesh``, each replica in a host
    thread of its own that lives as long as the runner, so that what
    PyTorch keeps per thread (cuDNN's execution plans, library handles)
    is built once and not at every run. On a card each replica also has a
    CUDA stream of its own (``streams``). The threads end when the runner
    is collected."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.streams = (None if mesh.devices[0].type != "cuda" else
                        [torch.cuda.Stream(d) for d in mesh.devices])
        self._lock = threading.Lock()
        self._jobs = [queue.SimpleQueue() for _ in mesh.devices]
        self._threads = None

    def _start_threads(self) -> None:
        # the threads hold their queues only, never the runner
        self._threads = [threading.Thread(target=_serve_jobs, args=(jobs,),
                                          name=f"replica{rank}", daemon=True)
                         for rank, jobs in enumerate(self._jobs)]
        for t in self._threads:
            t.start()
        weakref.finalize(self, _stop_threads, self._jobs)

    def run(self, fn: Callable[[int], object]) -> list:
        """``fn(rank)`` for every replica, in its thread, with its card
        current, its stream as the current stream and ``replica_max``
        taken across the replicas; the threads take turns
        (``ReplicaGroup``). Each stream first waits for the calling
        thread's current stream on its device (what was enqueued before
        the run), and the caller's current streams wait for the replicas'
        (what is enqueued after). Runs from several callers go one at a
        time. Returns the results in mesh order; if a replica raises, the
        others stop at their next turn and its exception is raised."""
        mesh, streams = self.mesh, self.streams
        with self._lock:
            if self._threads is None:
                self._start_threads()
            if streams is not None:
                for stream, device in zip(streams, mesh.devices):
                    stream.wait_stream(torch.cuda.current_stream(device))
            group = ReplicaGroup(mesh, streams)
            results: list = [None] * mesh.size
            errors: list = [None] * mesh.size
            ended = threading.Semaphore(0)

            def job(rank: int) -> None:
                try:
                    with ExitStack() as stack:
                        stack.enter_context(device_scope(mesh.devices[rank]))
                        if streams is not None:
                            stack.enter_context(
                                torch.cuda.stream(streams[rank]))
                        stack.enter_context(replica_scope(group, rank))
                        group.start(rank)
                        results[rank] = fn(rank)
                    group.finish(rank)
                except BaseException as exc:  # noqa: BLE001 — to the caller
                    errors[rank] = exc
                    group.fail()
                finally:
                    ended.release()

            for rank, jobs in enumerate(self._jobs):
                jobs.put(functools.partial(job, rank))
            for _ in range(mesh.size):
                ended.acquire()
            if streams is not None:
                for stream, device in zip(streams, mesh.devices):
                    torch.cuda.current_stream(device).wait_stream(stream)
        failed = [e for e in errors if e is not None]
        if failed:
            # a replica stopped by another's failure reports a
            # ReplicaError: raise the failure that caused it
            raise next((e for e in failed
                        if not isinstance(e, ReplicaError)), failed[0])
        return results
