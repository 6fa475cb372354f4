"""Learning-rate schedules (reference yolo/optim/lr_schedulers/build.py),
the port's copy of the JAX package's optim/schedules.py.

One function of the GLOBAL micro-step gives the reference's two-level
scheme:

  * per-iteration linear warmup for epoch < WARMUP_EPOCH:
      lr = base * (1 + step) / (WARMUP_EPOCH * len_epoch)
    (lr_schedulers/build.py:17-27);
  * then an epoch-level scheduler stepped once per post-warmup epoch:
      - MultiStepLR with milestones shifted by -warmup (build.py:37-43):
        gamma^(number of original milestones <= epoch), bisect_right;
      - CosineAnnealingLR over (MAX_EPOCHS - warmup) epochs (build.py:
        44-50).

Evaluated in float32, as the JAX package's traced schedule is.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np

_F32 = np.float32


def build_lr_schedule(cfg: Dict, len_epoch: int) -> Callable[[int], float]:
    """Returns lr(global_micro_step) -> float."""
    base_lr = _F32(cfg["OPTIMIZER"]["LR"])
    sched = cfg["LR_SCHEDULER"]
    is_warmup = bool(sched.get("IS_WARMUP", False))
    warmup_epoch = int(sched.get("WARMUP_EPOCH", 0)) if is_warmup else 0
    sched_type = sched["TYPE"]

    if sched_type == "MultiStepLR":
        milestones = sorted(int(m) for m in sched["MILESTONES"])
        gamma = _F32(sched["GAMMA"])

        def post_warmup_lr(epoch: int) -> np.float32:
            n = sum(epoch >= m for m in milestones)
            return base_lr * gamma ** _F32(n)

    elif sched_type == "CosineAnnealingLR":
        t_max = int(cfg["TRAIN"]["MAX_EPOCHS"]) - warmup_epoch
        if t_max <= 0:
            # t_max = 0 makes the post-warmup LR 0/0 (NaN parameters with
            # no error); a negative t_max inverts the curve
            raise ValueError(
                f"CosineAnnealingLR needs MAX_EPOCHS > WARMUP_EPOCH "
                f"(got {cfg['TRAIN']['MAX_EPOCHS']} <= {warmup_epoch})")
        eta_min = _F32(sched["MINIMAL_LR"])

        def post_warmup_lr(epoch: int) -> np.float32:
            k = _F32(epoch - warmup_epoch)
            return eta_min + (base_lr - eta_min) * (
                _F32(1) + np.cos(_F32(np.pi) * k / _F32(t_max))) / _F32(2)

    else:
        raise ValueError(f"{sched_type} does not support.")

    warmup_total = warmup_epoch * len_epoch

    def schedule(global_step: int) -> float:
        global_step = int(global_step)
        if global_step < warmup_total:
            return float(base_lr * (_F32(1) + _F32(global_step))
                         / _F32(warmup_total))
        return float(post_warmup_lr(global_step // len_epoch))

    return schedule
