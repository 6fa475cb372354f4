"""The train steps in plain PyTorch: forward in train mode, the loss,
backward and Adam (betas 0.9 / 0.999, eps 1e-8, no weight decay: the
program's optimizer for both configurations), in float32 with TF32 off,
or in the fp8 control (the reference module's ``precision``).

Each BatchNorm normalizes with its batch's statistics; the model
recomputes each stage in the backward (activation checkpointing) so that
a float32 step at the program's batch fits beside nothing else on the
card.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Iterator, List

import torch

from portbench import reference


class Adam:
    """torch.optim.Adam's update, written out."""

    def __init__(self, params: List[torch.Tensor], b1=0.9, b2=0.999,
                 eps=1e-8):
        self.params, self.b1, self.b2, self.eps = params, b1, b2, eps
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.t = 0

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor], lr: float) -> None:
        self.t += 1
        c1, c2 = 1.0 - self.b1 ** self.t, 1.0 - self.b2 ** self.t
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            denom = v.sqrt() / c2 ** 0.5 + self.eps
            p.addcdiv_(m, denom, value=-lr / c1)


class RefSteps:
    """The configuration's reference model (its ``reference`` module), its
    input, loss and Adam from ``state_dict``; ``step`` runs one update and
    returns the loss and the gradients, by parameter name."""

    def __init__(self, config: Dict, state_dict: Dict, device,
                 lr: Callable[[int], float], start_step: int,
                 mode: str = "float32"):
        self.ref, self.kind = reference.module(config), config["model"]
        with torch.device("meta"):
            model = reference.build(config)
        self.model = model.to_empty(device=device)
        self.model.load_state_dict(state_dict)
        self.ref.precision(self.model, mode).train()
        self.model.checkpointed = True
        self.names = [n for n, _ in self.model.named_parameters()]
        self.params = [p for _, p in self.model.named_parameters()]
        self.adam = Adam(self.params)
        self.lr, self.global_step = lr, start_step

    def step(self, images: torch.Tensor, labels: torch.Tensor):
        out = self.model(self.ref.model_input(self.kind, images))
        loss = self.ref.loss(self.kind, out, labels)
        grads = torch.autograd.grad(loss, self.params)
        self.adam.step(list(grads), self.lr(self.global_step))
        self.global_step += 1
        return loss.detach(), dict(zip(self.names, grads))

    def parameters(self) -> Dict[str, torch.Tensor]:
        return dict(zip(self.names, self.params))


@contextlib.contextmanager
def tf32_off() -> Iterator[None]:
    """Float32 products without TF32 inside the block (the reference's
    precision); the flags are put back after it."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
