"""Optimizers and learning-rate schedules."""

from yolov4_tpu_torch.optim.optimizers import build_optimizer, decay_mask
from yolov4_tpu_torch.optim.schedules import build_lr_schedule

__all__ = ["build_lr_schedule", "build_optimizer", "decay_mask"]
