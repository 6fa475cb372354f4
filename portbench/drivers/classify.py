"""The classifier's train step (``"driver": "classify"``):
``make_cls_train_step`` (normalize, CSPDarknet53, smoothed cross-entropy,
backward, Adam) as the ``darknet_pretrain`` CLI builds it, over uint8
crops and labels made on the device. Set-up and the window are the
detector's (portbench/drivers/train.py).

Traffic keys: ``batch``, ``img_size`` (the crop), ``pool``,
``start_epoch``, ``len_epoch``.
"""

from __future__ import annotations

import torch

from portbench import weights
from portbench.drivers.train import Driver as TrainDriver


class Driver(TrainDriver):
    RATE = "pretrain_img_per_s"
    SMALL = dict(batch=4, img_size=64, pool=4)

    def pool(self):
        return weights.classify_pool(self.seed, int(self.traffic["pool"]),
                                     self.batch, self.size, self.n_classes,
                                     self.device)

    def base_lr(self) -> float:
        """The classifier's Adam rate: lr x batch / 256 (main_amp.py:154)."""
        return self.config["lr"] * self.batch / 256.0

    def schedule(self):
        cf = self.config
        return (self.base_lr(),
                cf["warmup_epochs"] * int(self.traffic["len_epoch"]),
                cf["milestones"], cf["gamma"])

    def program(self, width: float, depth: float):
        from yolov4_tpu_torch.classify.trainer import (classifier_lr_schedule,
                                                        make_cls_train_step)
        from yolov4_tpu_torch.models.darknet import CSPDarknet53
        model = CSPDarknet53(self.n_classes, width=width, depth=depth,
                             generator=torch.Generator().manual_seed(0))
        model = model.to(self.device)
        if self.device.type == "cuda":
            model = model.to(memory_format=torch.channels_last)
        base_lr = self.base_lr()
        optimizer = torch.optim.Adam(model.parameters(), lr=base_lr,
                                     betas=(0.9, 0.999), eps=1e-8)
        lr = classifier_lr_schedule(base_lr, int(self.traffic["len_epoch"]))
        dtype = getattr(torch, self.config["compute_dtype"])
        step = make_cls_train_step(model, optimizer, lr, dtype)
        return model, step, optimizer
