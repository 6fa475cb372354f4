"""The entry points' device rule and the per-thread card binding, shared by
the Predictor (engine/predictor.py) and the mesh (parallel/mesh.py)."""

from __future__ import annotations

from contextlib import nullcontext

import torch


def resolve_device(device=None) -> torch.device:
    """The entry points' device rule: CUDA unless the caller names another
    device (``cuda:N`` for a rank's card). Asking for CUDA where there is
    none, or for a card index that does not exist, raises; nothing falls
    back to the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA was requested but torch.cuda.is_available() "
                           "is False; pass device='cpu' to run on the CPU")
    if (device.type == "cuda" and device.index is not None
            and device.index >= torch.cuda.device_count()):
        raise RuntimeError(f"{device} was requested but there are "
                           f"{torch.cuda.device_count()} CUDA device(s)")
    return device


def device_scope(device: torch.device):
    """Make ``device`` the current card of the calling thread (new threads
    start on card 0)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return nullcontext()
