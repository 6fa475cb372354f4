"""The train step: the port's copy of the JAX package's
parallel/train_step.py, on one device or data-parallel over the ranks of a
process group (one process per GPU, parallel/dist.py).

One call is one micro-step (the reference's loop body, engine/build.py:
55-69):

  * with ``device_aug``, the batch is uint8 mosaic canvases and member
    boxes, augmented first on their device (data/device_aug.py) from a
    generator seeded by (``aug_seed``, micro-step): the stream depends on
    the seed and the step alone, so a resumed run repeats it; rank r > 0
    draws from (``aug_seed``, micro-step, r);
  * the forward in train mode under ``torch.autocast`` when the compute
    dtype is bfloat16 (the parameters stay float32), the loss in float32;
  * the backward of loss / ACCUMULATION_STEPS, summed into ``.grad``;
  * every ACCUMULATION_STEPS micro-steps an optimizer update at the
    learning rate of the CURRENT micro-step (the per-iteration warmup,
    reference lr_schedulers/build.py:17-27), then the gradients are zeroed
    and, with an EMA decay d > 0, the shadow weights become
    d * ema + (1 - d) * params;
  * ``skip_nonfinite``: a micro-batch whose loss or gradients are not
    finite adds nothing to the gradient sum, and the BatchNorm buffers are
    restored to their values before its forward (a momentum blend with a
    NaN batch statistic would stay NaN). The check runs on the device,
    with no host synchronisation.

Data-parallel (``dist``, a process group of W ranks, each with its own
slice of the global batch) it computes the JAX shard body's function at
W devices:

  * gradients: DDP (``parallel/dist.wrap_ddp``) averages the accumulated
    ``.grad`` over the ranks in the backward of each update's micro-step;
    the other micro-steps run under ``no_sync``. A mean of sums is the JAX
    package's sum of per-micro-step ``pmean``s;
  * BatchNorm is per replica: each rank normalises with its own batch's
    statistics, and after each micro-step every running mean and variance
    becomes its rank-mean (``pmean(new_batch_stats)``); DDP leaves the
    buffers alone;
  * the reported loss is the rank-mean;
  * ``skip_nonfinite`` takes its gradients with ``torch.autograd.grad``,
    past DDP, and averages them, the loss and the BN statistics itself
    before the check, so every rank keeps or drops the micro-batch alike;
  * EMA: each rank keeps one; the ranks' parameters are equal, so are
    their EMAs.

The state's ``loss`` is the undivided loss of the last micro-step (the
rank-mean data-parallel), as a device scalar.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch
import torch.distributed as tdist
from torch import nn

from yolov4_tpu_torch.data.device_aug import augment_batch
from yolov4_tpu_torch.models.decode import at_least_f32
from yolov4_tpu_torch.parallel.dist import all_reduce_mean_, wrap_ddp
from yolov4_tpu_torch.utils.profiling import span


@dataclass
class TrainState:
    """What a step changes besides the model's parameters, buffers and
    ``.grad`` and the optimizer's state."""

    step: int = 0                      # global micro-step counter
    loss: Optional[torch.Tensor] = None
    # TRAIN.EMA_DECAY > 0: shadow copies of the parameters by name
    ema_params: Optional[Dict[str, torch.Tensor]] = None


def create_train_state(model: nn.Module, ema: bool = False) -> TrainState:
    ema_params = None
    if ema:
        ema_params = {n: p.detach().clone()
                      for n, p in model.named_parameters()}
    return TrainState(step=0, ema_params=ema_params)


def images_to_input(images: torch.Tensor) -> torch.Tensor:
    """NHWC device batch -> the model's NCHW float input: uint8 is scaled
    by 1/255, bfloat16 and float32 become float32 and float64 stays
    float64 (already /255). The permuted view is channels-last in
    memory."""
    x = images.permute(0, 3, 1, 2)
    if x.dtype == torch.uint8:
        return x.float() / 255.0
    return at_least_f32(x)


def aug_generator(device: torch.device, aug_seed: int, step: int,
                  shard: int = 0) -> torch.Generator:
    """The device augmentation's generator of micro-step ``step`` on rank
    ``shard`` (the JAX package's ``fold_in(fold_in(key, step), shard)``).
    Shard 0 keeps the one-process stream of (seed, step)."""
    key = (aug_seed, step) if shard == 0 else (aug_seed, step, shard)
    gen = torch.Generator(device=device)
    gen.manual_seed(hash(key) & 0x7FFFFFFFFFFFFFFF)
    return gen


def make_train_step(model: nn.Module, criterion, optimizer: torch.optim.Optimizer,
                    lr_schedule: Callable[[int], float],
                    accumulation_steps: int = 1,
                    compute_dtype: torch.dtype = torch.float32,
                    skip_nonfinite: bool = False,
                    ema_decay: float = 0.0,
                    device_aug: Optional[Dict] = None,
                    aug_seed: int = 0,
                    dist: Optional[tdist.ProcessGroup] = None) -> Callable:
    """Returns step(state, images, labels) -> state.

    images: [B, S, S, 3] NHWC on the model's device (uint8, or float in
    [0, 1]); labels: [B, K, 5] float32 (cx, cy, w, h, cls) in input
    pixels. The model, its optimizer and ``state`` are updated in place.

    ``device_aug`` (augment_batch's keyword arguments besides size and
    max_labels): images are uint8 canvases [B, 4, S, S, 3] and labels the
    member boxes [B, 4, K, 5] (x1, y1, x2, y2, cls in canvas pixels); the
    step augments them into [B, S, S, 3] and [B, K, 5] first.

    ``dist``: the process group to train over data-parallel, each rank
    passing its own slice of the batch (even at one rank, DDP wraps the
    model); None for one process. ``model`` stays the unwrapped module, so
    its parameter and buffer names (checkpoints, EMA) carry no prefix.
    """
    params = [p for p in model.parameters()]
    names = [n for n, _ in model.named_parameters()]
    buffers = list(model.buffers())
    bn_stats = [b for n, b in model.named_buffers()
                if n.endswith(("running_mean", "running_var"))]
    autocast = compute_dtype == torch.bfloat16
    shard = 0 if dist is None else tdist.get_rank(dist)
    ddp = None
    if dist is not None and not skip_nonfinite:
        ddp = wrap_ddp(model, dist)
    elif dist is not None:
        # skip_nonfinite takes its gradients past DDP's reducer; start from
        # rank 0's parameters all the same, as DDP's construction does
        with torch.no_grad():
            for p in params:
                tdist.broadcast(p, tdist.get_global_rank(dist, 0), group=dist)

    def step(state: TrainState, images: torch.Tensor,
             labels: torch.Tensor) -> TrainState:
        model.train()
        if device_aug is not None:
            gen = aug_generator(images.device, aug_seed, state.step, shard)
            images, labels = augment_batch(
                gen, images, labels, size=images.shape[2],
                max_labels=labels.shape[2], **device_aug)
        x = images_to_input(images)
        update = (state.step + 1) % accumulation_steps == 0
        if skip_nonfinite:
            saved = [b.clone() for b in buffers]
        # DDP reduces the gradients in the backward of an update's
        # micro-step only
        sync = (ddp.no_sync() if ddp is not None and not update
                else contextlib.nullcontext())
        with sync:
            with span("train.forward"), torch.autocast(
                    x.device.type, dtype=torch.bfloat16, enabled=autocast):
                outputs = (model if ddp is None else ddp)(x)
            with span("train.loss"):
                loss = criterion(outputs, {"padded_labels": labels})
            scaled = loss / accumulation_steps
            with span("train.backward"):
                if skip_nonfinite:
                    grads = torch.autograd.grad(scaled, params,
                                                allow_unused=True)
                else:
                    scaled.backward()
        loss = loss.detach()
        if dist is not None:
            # rank-means of the loss and the BN statistics (and, past DDP,
            # of the gradients) in one all-reduce per dtype
            loss = loss.clone()
            reduced = ([g for g in grads if g is not None]
                       if skip_nonfinite else [])
            all_reduce_mean_([loss, *bn_stats, *reduced], dist)
        if skip_nonfinite:
            finite = torch.isfinite(loss)
            for g in grads:
                if g is not None:
                    finite = finite & torch.isfinite(g).all()
            with torch.no_grad():
                for p, g in zip(params, grads):
                    if g is None:
                        continue
                    prev = p.grad if p.grad is not None else torch.zeros_like(g)
                    p.grad = torch.where(finite, prev + g, prev)
                for b, s in zip(buffers, saved):
                    b.copy_(torch.where(finite, b, s))

        if update:
            with span("train.update"):
                lr = lr_schedule(state.step)
                for group in optimizer.param_groups:
                    group["lr"] = lr
                optimizer.step()
                optimizer.zero_grad(set_to_none=True)
                if ema_decay > 0.0:
                    with torch.no_grad():
                        ema = [state.ema_params[n] for n in names]
                        torch._foreach_mul_(ema, ema_decay)
                        torch._foreach_add_(ema,
                                            [p.detach() for p in params],
                                            alpha=1.0 - ema_decay)
        state.step += 1
        state.loss = loss
        return state

    return step
