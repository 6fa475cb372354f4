"""The train step on one device: the port's copy of the JAX package's
parallel/train_step.py for a one-device mesh.

One call is one micro-step (the reference's loop body, engine/build.py:
55-69):

  * with ``device_aug``, the batch is uint8 mosaic canvases and member
    boxes, augmented first on their device (data/device_aug.py) from a
    generator seeded by (``aug_seed``, micro-step): the stream depends on
    the seed and the step alone, so a resumed run repeats it;
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

The state's ``loss`` is the undivided loss of the last micro-step, as a
device scalar. Data parallelism (DDP) is not here.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch
from torch import nn

from yolov4_tpu_torch.data.device_aug import augment_batch
from yolov4_tpu_torch.models.decode import at_least_f32


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


def aug_generator(device: torch.device, aug_seed: int,
                  step: int) -> torch.Generator:
    """The device augmentation's generator of micro-step ``step`` (the
    JAX package's ``fold_in(fold_in(key, step), shard)``, shard 0)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(hash((aug_seed, step)) & 0x7FFFFFFFFFFFFFFF)
    return gen


def make_train_step(model: nn.Module, criterion, optimizer: torch.optim.Optimizer,
                    lr_schedule: Callable[[int], float],
                    accumulation_steps: int = 1,
                    compute_dtype: torch.dtype = torch.float32,
                    skip_nonfinite: bool = False,
                    ema_decay: float = 0.0,
                    device_aug: Optional[Dict] = None,
                    aug_seed: int = 0) -> Callable:
    """Returns step(state, images, labels) -> state.

    images: [B, S, S, 3] NHWC on the model's device (uint8, or float in
    [0, 1]); labels: [B, K, 5] float32 (cx, cy, w, h, cls) in input
    pixels. The model, its optimizer and ``state`` are updated in place.

    ``device_aug`` (augment_batch's keyword arguments besides size and
    max_labels): images are uint8 canvases [B, 4, S, S, 3] and labels the
    member boxes [B, 4, K, 5] (x1, y1, x2, y2, cls in canvas pixels); the
    step augments them into [B, S, S, 3] and [B, K, 5] first.
    """
    params = [p for p in model.parameters()]
    names = [n for n, _ in model.named_parameters()]
    buffers = list(model.buffers())
    autocast = compute_dtype == torch.bfloat16

    def step(state: TrainState, images: torch.Tensor,
             labels: torch.Tensor) -> TrainState:
        model.train()
        if device_aug is not None:
            gen = aug_generator(images.device, aug_seed, state.step)
            images, labels = augment_batch(
                gen, images, labels, size=images.shape[2],
                max_labels=labels.shape[2], **device_aug)
        x = images_to_input(images)
        if skip_nonfinite:
            saved = [b.clone() for b in buffers]
        with torch.autocast(x.device.type, dtype=torch.bfloat16,
                            enabled=autocast):
            outputs = model(x)
        loss = criterion(outputs, {"padded_labels": labels})
        scaled = loss / accumulation_steps
        if skip_nonfinite:
            grads = torch.autograd.grad(scaled, params, allow_unused=True)
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
        else:
            scaled.backward()

        if (state.step + 1) % accumulation_steps == 0:
            lr = lr_schedule(state.step)
            for group in optimizer.param_groups:
                group["lr"] = lr
            optimizer.step()
            optimizer.zero_grad(set_to_none=True)
            if ema_decay > 0.0:
                with torch.no_grad():
                    ema = [state.ema_params[n] for n in names]
                    torch._foreach_mul_(ema, ema_decay)
                    torch._foreach_add_(ema, [p.detach() for p in params],
                                        alpha=1.0 - ema_decay)
        state.step += 1
        state.loss = loss.detach()
        return state

    return step
