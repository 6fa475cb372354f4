"""The max over the replicas of a detection run, where the detection
program's batch-global reductions call it: the NMS's class-offset span
(ops/postprocess.py) and each dynamic int8 abs-max (models/layers.py).
Outside a scope it returns its argument, so a plain predictor (and an
exported program) is unchanged.

Two kinds of run enter a scope, never one inside the other:

  * a single-process mesh run (parallel/mesh.py) enters ``replica_scope``
    in each replica's thread with the run's group, which takes the max
    across the replicas (``parallel/mesh.ReplicaGroup.all_max``);
  * a predictor over the ranks of a ``torch.distributed`` group (one
    process a rank, as torchrun starts them: the JAX package's predictor
    over a multi-process mesh) enters ``group_scope``, which takes the max
    over the group's ranks with one all-reduce.
"""

from __future__ import annotations

import functools
import threading
from contextlib import contextmanager
from typing import Callable, Iterator

import torch
import torch.distributed as tdist

# the max of the run this thread belongs to: value -> max over its replicas
_replica = threading.local()


def replica_max(value: torch.Tensor) -> torch.Tensor:
    """``value``'s max over the replicas of the run that this thread
    belongs to, or ``value`` itself outside one. Each replica must call it
    the same number of times."""
    all_max = getattr(_replica, "all_max", None)
    return value if all_max is None else all_max(value)


@contextmanager
def _scope(all_max: Callable[[torch.Tensor], torch.Tensor]) -> Iterator[None]:
    if getattr(_replica, "all_max", None) is not None:
        raise RuntimeError("replica_max scopes do not nest: this thread "
                           "already runs as a replica")
    _replica.all_max = all_max
    try:
        yield
    finally:
        _replica.all_max = None


def replica_scope(group, rank: int):
    """Inside the block ``replica_max`` on this thread is ``group``'s max
    (a parallel/mesh.ReplicaGroup), as replica ``rank``."""
    return _scope(functools.partial(group.all_max, rank))


def _rank_max(group: tdist.ProcessGroup, value: torch.Tensor) -> torch.Tensor:
    out = value.clone()
    # NCCL enqueues the reduction on the current stream: the host does not
    # wait for the device. Gloo takes a CUDA tensor as well (two ranks
    # sharing one card, where NCCL refuses them): it copies the value to
    # the host and back itself, so there the host waits for the device.
    tdist.all_reduce(out, op=tdist.ReduceOp.MAX, group=group)
    return out


def group_scope(group: tdist.ProcessGroup):
    """Inside the block ``replica_max`` on this thread is the max over the
    ranks of the ``torch.distributed`` group ``group``, on the value's own
    device. Every rank of the group must run the same calls."""
    return _scope(functools.partial(_rank_max, group))
