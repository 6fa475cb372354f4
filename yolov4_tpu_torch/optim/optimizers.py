"""Optimizers (reference yolo/optim/optimizers/:14-80), the port's copy of
the JAX package's optim/optimizers.py as ``torch.optim`` optimizers.

The learning rate is set by the train step before every update from the
schedule at the current micro-step (the reference's per-iteration warmup
writes to ``param_group['lr']``, lr_schedulers/build.py:17-27).

Weight-decay grouping matches ``filter_weight`` (optimizers/build.py:
38-80): conv kernels decay; biases are exempt when NO_BIAS; BatchNorm
weight and bias are exempt when NO_NORM. As in the reference, ADAM ignores
weight decay (build_adam takes no decay argument, optimizers/adam.py:14).

SGD is torch's with momentum, no dampening and no Nesterov, the decay added
to the gradient of the decayed group before the momentum: the same update
as optax ``add_decayed_weights`` then ``trace``, whose first step also
sets the trace to the gradient.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

import torch
from torch import nn


def decay_mask(named_params: Iterable[Tuple[str, torch.Tensor]],
               no_bias: bool = True, no_norm: bool = True) -> Dict[str, bool]:
    """{parameter name: True where weight decay applies}. BatchNorm
    parameters live under a module named ``norm`` (``...norm.weight``,
    ``...norm.bias``)."""
    mask = {}
    for name, _ in named_params:
        parts = name.split(".")
        if "norm" in parts[:-1]:
            mask[name] = not no_norm
        elif parts[-1] == "bias":
            mask[name] = not no_bias
        else:
            mask[name] = True
    return mask


def build_optimizer(cfg: Dict, model: nn.Module) -> torch.optim.Optimizer:
    """The reference's optimizer (optim/optimizers/build.py:18-35) over
    ``model``'s parameters, its learning rate OPTIMIZER.LR until the train
    step sets it."""
    opt_cfg = cfg["OPTIMIZER"]
    opt_type = opt_cfg["TYPE"]
    lr = float(opt_cfg["LR"])
    named = list(model.named_parameters())
    if opt_type == "ADAM":
        # torch Adam defaults: betas (0.9, 0.999), eps 1e-8, no decay
        return torch.optim.Adam([p for _, p in named], lr=lr,
                                betas=(0.9, 0.999), eps=1e-8)
    if opt_type == "SGD":
        mask = decay_mask(named, bool(opt_cfg.get("NO_BIAS", True)),
                          bool(opt_cfg.get("NO_NORM", True)))
        decay = float(opt_cfg["DECAY"])
        groups = [
            {"params": [p for n, p in named if mask[n]],
             "weight_decay": decay},
            {"params": [p for n, p in named if not mask[n]],
             "weight_decay": 0.0},
        ]
        return torch.optim.SGD([g for g in groups if g["params"]], lr=lr,
                               momentum=float(opt_cfg["MOMENTUM"]),
                               dampening=0.0, nesterov=False)
    raise ValueError(f"{opt_type} does not support.")
