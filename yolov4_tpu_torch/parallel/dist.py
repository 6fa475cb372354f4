"""Process groups for data-parallel training: the port's counterpart of the
JAX package's parallel/mesh.py.

The JAX package runs one process per host over a mesh of all its chips;
the port runs one process per GPU, as the reference did (apex DDP over
NCCL, main_amp.py:94-131) and as ``torchrun --nproc_per_node N`` starts
them. Each process is one rank: it reads RANK, WORLD_SIZE and LOCAL_RANK
from torchrun's environment and trains on ``cuda:{LOCAL_RANK}``.

Two groups exist once ``init_distributed`` has run:

  * the default group (NCCL for CUDA, gloo for the CPU), over which DDP
    averages gradients and the train step averages BN statistics;
  * the host group (gloo), for host data: validation rows, image ids, AP
    stats and the lockstep barriers. Gloo's CUDA support covers only
    broadcast, all_reduce and barrier, and the JAX package too gathers
    numpy on the host (``multihost_utils.process_allgather``).

Without a WORLD_SIZE in the environment (and no coordinator) nothing is
initialised and every query below answers for one process.
"""

from __future__ import annotations

import os
import warnings
from datetime import timedelta
from typing import Optional, Sequence

import torch
import torch.distributed as tdist

DEFAULT_TIMEOUT_S = 1800

# the gloo group for host data; the default group when that is gloo
_HOST_GROUP: Optional[tdist.ProcessGroup] = None


def init_distributed(coordinator: Optional[str] = None,
                     backend: Optional[str] = None,
                     timeout_s: float = DEFAULT_TIMEOUT_S,
                     device="cuda",
                     init_method: Optional[str] = None) -> bool:
    """Join the process group that torchrun's environment describes;
    returns whether one is up.

    ``coordinator`` ("host:port") fills MASTER_ADDR and MASTER_PORT for a
    multi-node run, as the JAX package's ``initialize_runtime`` hands it to
    ``jax.distributed``. ``backend`` defaults to NCCL when ``device`` is a
    CUDA device and to gloo otherwise. ``init_method`` defaults to
    ``env://``; a ``file://`` path rendezvous without a TCP port. Every
    collective waits at most ``timeout_s``. A second call, or a call with
    no WORLD_SIZE in the environment and no coordinator, does nothing.
    """
    global _HOST_GROUP
    if tdist.is_initialized():
        return True
    if coordinator:
        host, _, port = coordinator.rpartition(":")
        if not host or not port.isdigit():
            raise ValueError(f"coordinator must be host:port, got "
                             f"{coordinator!r}")
        os.environ["MASTER_ADDR"], os.environ["MASTER_PORT"] = host, port
    elif "WORLD_SIZE" not in os.environ:
        return False
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    timeout = timedelta(seconds=timeout_s)
    tdist.init_process_group(
        backend, init_method=init_method or "env://", timeout=timeout,
        rank=int(os.environ.get("RANK", 0)),
        world_size=int(os.environ.get("WORLD_SIZE", 1)))
    _HOST_GROUP = (tdist.group.WORLD if backend == "gloo"
                   else tdist.new_group(backend="gloo", timeout=timeout))
    return True


def shutdown() -> None:
    """Leave the process groups (a no-op when none is up)."""
    global _HOST_GROUP
    if tdist.is_initialized():
        tdist.destroy_process_group()
    _HOST_GROUP = None


def rank() -> int:
    return tdist.get_rank() if tdist.is_initialized() else 0


def world_size() -> int:
    return tdist.get_world_size() if tdist.is_initialized() else 1


def is_primary() -> bool:
    """Rank 0: the one process that writes logs, metrics and checkpoints."""
    return rank() == 0


def local_rank() -> int:
    """This process's index on its node (torchrun's LOCAL_RANK)."""
    return int(os.environ.get("LOCAL_RANK", 0))


def world_group() -> Optional[tdist.ProcessGroup]:
    """The group the train step reduces over; None without one."""
    return tdist.group.WORLD if tdist.is_initialized() else None


def host_group() -> Optional[tdist.ProcessGroup]:
    """The gloo group for host data; None without one."""
    return _HOST_GROUP


def device_for_rank(device) -> torch.device:
    """A bare ``cuda`` becomes ``cuda:{LOCAL_RANK}`` and the current CUDA
    device, so that kernels, streams, generators and pinned uploads of this
    rank all find its card; any other device is returned as it is."""
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", local_rank())
        torch.cuda.set_device(device)
    return device


def lockstep(name: str, timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Barrier of every rank on the host group (the JAX package's
    ``coordinator_lockstep``); a rank that does not arrive within
    ``timeout_s`` is named in the error. No-op for one process."""
    if world_size() <= 1:
        return
    try:
        tdist.monitored_barrier(group=_HOST_GROUP,
                                timeout=timedelta(seconds=timeout_s),
                                wait_all_ranks=True)
    except RuntimeError as err:
        raise RuntimeError(f"lockstep '{name}' failed: {err}") from err


def all_reduce_mean_(tensors: Sequence[torch.Tensor],
                     group: Optional[tdist.ProcessGroup] = None) -> None:
    """Replace each tensor by its mean over the ranks of ``group``, in
    place: one all-reduce (a sum, then a division by the world size, which
    every backend supports) per dtype and device over their flattened
    concatenation."""
    world = tdist.get_world_size(group)
    buckets = {}
    for t in tensors:
        buckets.setdefault((t.dtype, t.device), []).append(t)
    for ts in buckets.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        tdist.all_reduce(flat, op=tdist.ReduceOp.SUM, group=group)
        flat /= world
        torch._foreach_copy_(ts, [v.view_as(t) for v, t in
                                  zip(flat.split([t.numel() for t in ts]),
                                      ts)])


def wrap_ddp(model: torch.nn.Module,
             group: tdist.ProcessGroup) -> torch.nn.parallel.DistributedDataParallel:
    """DDP over ``group`` that leaves the buffers alone: BatchNorm is per
    replica, and the train step averages its running statistics itself
    (the JAX package's ``pmean(new_batch_stats)``). DDP's default copies
    rank 0's buffers to every rank before each forward instead, another
    function. ``broadcast_buffers=False`` means the same from torch 2.11 on
    (no buffer copy at construction nor at a forward); later versions
    deprecate the name in favour of ``forward_sync_buffers``, whose False
    still copies them at construction, so the old name stays and its
    warning is silenced. The parameters are broadcast from rank 0 at
    construction, as always."""
    device = next(model.parameters()).device
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*broadcast_buffers.*")
        return torch.nn.parallel.DistributedDataParallel(
            model, device_ids=[device] if device.type == "cuda" else None,
            broadcast_buffers=False, process_group=group)
