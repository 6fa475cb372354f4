"""The detector's train step (``"driver": "train"``): ``make_train_step``
(forward, ``YOLOLoss``, backward, Adam) as the ``train`` CLI builds it.
Set-up builds the step object and drives it from the seed through its
first ``CHECKED_STEPS`` steps on distinct batches (the check's readings);
the window drives that same object over the pool, and ends in a
synchronize. The rate is the images stepped over the window.

Traffic keys: ``batch``, ``img_size``, ``max_labels``, ``boxes`` (the
least and most boxes an image), ``pool``, ``start_epoch`` and
``len_epoch`` (the schedule's position), ``cfg``.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List

import numpy as np
import torch

from portbench import check, weights
from portbench.drivers import Driver as Base
from portbench.drivers import program_cfg, sync
from portbench.reference.train import RefSteps, tf32_off

# the steps set-up drives and the reference follows
CHECKED_STEPS = 3


@torch.no_grad()
def _norms(tensors) -> List[float]:
    return [float(n) for n in torch.stack(torch._foreach_norm(
        [t.detach().float() for t in tensors])).cpu()]


class Driver(Base):
    RATE = "train_img_per_s"
    FAULTS = ("half_batch", "unchanged")
    SMALL = dict(batch=4, img_size=64, pool=4, max_labels=8)

    def pool(self):
        """(images, labels), ``pool`` batches made on the device."""
        tr = self.traffic
        return weights.train_pool(
            self.seed, int(tr["pool"]), self.batch, self.size,
            int(tr["max_labels"]), tuple(tr["boxes"]), self.n_classes,
            self.device)

    def program(self, width: float, depth: float):
        """(model, step, optimizer) as the ``train`` CLI builds them."""
        from yolov4_tpu_torch.models import build_model
        from yolov4_tpu_torch.ops.loss import build_criterion
        from yolov4_tpu_torch.optim import build_lr_schedule, build_optimizer
        from yolov4_tpu_torch.parallel.train_step import make_train_step
        tr = self.traffic
        cfg = program_cfg(self.config, tr)
        model = build_model(cfg, device=self.device, train=True)
        if self.device.type == "cuda":
            model = model.to(memory_format=torch.channels_last)
        optimizer = build_optimizer(cfg, model)
        lr = build_lr_schedule(cfg, len_epoch=int(tr["len_epoch"]))
        step = make_train_step(
            model, build_criterion(cfg), optimizer, lr,
            accumulation_steps=cfg["TRAIN"]["ACCUMULATION_STEPS"],
            compute_dtype=getattr(torch, cfg["MODEL"]["COMPUTE_DTYPE"]))
        return model, step, optimizer

    def schedule(self):
        """(base lr, warmup steps, milestone epochs, gamma) of the
        configuration."""
        opt = self.config["cfg"]["OPTIMIZER"]
        sch = self.config["cfg"]["LR_SCHEDULER"]
        warm = sch["WARMUP_EPOCH"] * int(self.traffic["len_epoch"])
        return opt["LR"], warm, sch["MILESTONES"], sch["GAMMA"]

    def setup(self) -> None:
        t = time.perf_counter()
        cf = self.config
        self.n_classes = int(cf["n_classes"])
        self.batch = int(self.traffic["batch"])
        self.size = int(self.traffic["img_size"])
        width, depth = cf.get("width", 1.0), cf.get("depth", 1.0)
        state = weights.make_weights(cf, self.seed, self.device)
        self.images, self.labels = self.pool()
        t = self._part("weights", t)
        self.model, step, self.optimizer = self.program(width, depth)
        self.model.load_state_dict(state)
        self.step = self.wrap(step)
        from yolov4_tpu_torch.parallel.train_step import TrainState
        self.state = TrainState(step=self.start_step())
        t = self._part("program", t)
        # the checked steps: the window's own call, on distinct batches
        names = [n for n, _ in self.model.named_parameters()]
        params = [p for _, p in self.model.named_parameters()]
        losses = []
        for k in range(CHECKED_STEPS):
            self.state = self.step(self.state, self.images[k],
                                   self.labels[k])
            losses.append(float("nan") if self.state.loss is None
                          else float(self.state.loss))
            if k == 0:
                opt = self.optimizer.state
                beta1 = self.optimizer.param_groups[0]["betas"][0]
                grad = _norms([opt[p]["exp_avg"] / (1.0 - beta1)
                               if p in opt else torch.zeros_like(p)
                               for p in params])
        with torch.no_grad():
            delta = _norms(torch._foreach_sub(params,
                                              [state[n] for n in names]))
        self.program_readings = {"loss": losses,
                                 "grad": dict(zip(names, grad)),
                                 "delta": dict(zip(names, delta))}
        self.state_cpu = {k: v.cpu() for k, v in state.items()}
        del state
        self._part("warmup", t)

    def start_step(self) -> int:
        tr = self.traffic
        return int(tr["start_epoch"]) * int(tr["len_epoch"])

    def lr_fn(self) -> Callable[[int], float]:
        """The configuration's learning rate by global step, worked out
        here from the configuration (not the program's function): a
        per-step linear warmup over the first epochs, then steps down by
        ``gamma`` at the milestones."""
        base, warm, milestones, gamma = self.schedule()
        len_epoch = int(self.traffic["len_epoch"])

        def lr(step: int) -> float:
            n = sum(step // len_epoch >= m for m in milestones)
            out = np.float32(base) * np.float32(gamma) ** np.float32(n)
            if step < warm:
                out = out * np.float32(1 + step) / np.float32(warm)
            return float(out)

        return lr

    def window(self, seconds: float, tracer) -> None:
        n_pool = self.images.shape[0]
        steps = 0
        with tracer.window():
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < seconds:
                b = (CHECKED_STEPS + steps) % n_pool
                with tracer.span("portbench.step"):
                    self.state = self.step(self.state, self.images[b],
                                           self.labels[b])
                steps += 1
            sync(self.device)
            self.window_s = time.perf_counter() - t0
        self.attempted = steps
        self.work = self.traced_images = steps * self.batch

    def release(self) -> None:
        del self.model, self.step, self.optimizer, self.state
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_readings(self, mode: str = "float32") -> Dict:
        """The reference (or, with ``mode`` "fp8", the control) through the
        checked steps, from the same weights on the same batches."""
        with tf32_off():
            ref = RefSteps(self.config, self.state_cpu, self.device,
                           self.lr_fn(), self.start_step(), mode)
            before = {k: v.detach().clone() for k, v in
                      ref.parameters().items()}
            losses = []
            for k in range(CHECKED_STEPS):
                loss, grads = ref.step(self.images[k], self.labels[k])
                losses.append(float(loss))
                if k == 0:
                    names = list(grads)
                    grad = dict(zip(names, _norms(grads.values())))
            after = ref.parameters()
            delta = dict(zip(names, _norms(
                [after[n] - before[n] for n in names])))
        return {"loss": losses, "grad": grad, "delta": delta}

    def check(self) -> Dict[str, List[float]]:
        ref = self.reference_readings()
        self.look = check.worst_leaves(self.program_readings, ref)
        gaps = check.train_gaps(self.program_readings, ref)
        return {k: [v] for k, v in gaps.items()}

    def readings(self, seconds: float) -> Dict:
        self.setup()
        self.release()
        out = {k: v[0] for k, v in self.check().items()}
        out["look"] = self.look
        return out

    def control(self, seconds: float) -> Dict:
        """The reference put in the program's place in float8 (conv inputs
        and weights e4m3, output gradients e5m2), below bfloat16."""
        self.setup()
        self.release()
        ctrl, ref = self.reference_readings("fp8"), self.reference_readings()
        return dict(check.train_gaps(ctrl, ref),
                    look=check.worst_leaves(ctrl, ref))
