"""The cross-replica max of a single-process mesh run (parallel/mesh.py),
where the detection program's batch-global reductions call it: the NMS's
class-offset span (ops/postprocess.py) and each dynamic int8 abs-max
(models/layers.py). Outside a replica it returns its argument, so a
predictor without a mesh (and an exported program) is unchanged.

A mesh run enters ``replica_scope`` in each replica's thread with the
run's group, which takes the max across the replicas
(``parallel/mesh.ReplicaGroup.all_max``).
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Iterator

import torch

# the (group, rank) of the replica running in this thread
_replica = threading.local()


def replica_max(value: torch.Tensor) -> torch.Tensor:
    """``value``'s max over the replicas of the mesh run that this thread
    belongs to, or ``value`` itself outside one. Each replica must call it
    the same number of times."""
    ctx = getattr(_replica, "ctx", None)
    if ctx is None:
        return value
    group, rank = ctx
    return group.all_max(rank, value)


@contextmanager
def replica_scope(group, rank: int) -> Iterator[None]:
    """Inside the block ``replica_max`` on this thread is ``group``'s max,
    as replica ``rank``."""
    _replica.ctx = (group, rank)
    try:
        yield
    finally:
        _replica.ctx = None
