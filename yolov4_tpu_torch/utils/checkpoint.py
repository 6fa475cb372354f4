"""Checkpoint save and resume: the port's copy of the JAX package's
utils/checkpoint.py, in ``torch.save`` files.

A full-state bundle is
``{"variables": state_dict, "opt_state": optimizer state_dict,
"meta": {...}}``, and with an EMA also ``"raw_params"``: then
``variables`` holds the EMA weights (what evaluation scored, so
val/detect load what the recorded AP measured) and ``raw_params`` the
training parameters that resume continues from. ``meta`` carries epoch,
step, the best APs and, for a mid-epoch save, ``mid_epoch`` and
``batch_index``. Every file is written to a temporary name and renamed,
so a preemption never leaves a truncated ``checkpoint.pth`` or
``model_best.pth``; a ``.meta.json`` copy of ``meta`` sits beside each.

``load_checkpoint_raw`` reads what a resume continues from: a port
checkpoint, or a JAX package ``.ckpt`` as its raw tree tagged with
``"layout": "jax"`` (``is_jax_layout``), which each trainer maps onto its
model and optimizer with ``utils/convert.bundle_from_jax`` (optax's Adam
and SGD state included).

``load_pretrained_backbone`` grafts the backbone of a port checkpoint, of
a reference ``.pth.tar`` (reference yolov4.py:295-302) or of a JAX package
``.ckpt`` (its ``backbone`` subtree, as the JAX package's
``load_pretrained_backbone``).
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional

import torch
from torch import nn

from yolov4_tpu_torch.utils.convert import (load_jax_checkpoint,
                                           load_weights, state_dict_from_jax,
                                           torch_load)

CKPT_NAME = "checkpoint.pth"
BEST_NAME = "model_best.pth"
META_SUFFIX = ".meta.json"
LAYOUT_KEY, JAX_LAYOUT = "layout", "jax"


def _atomic_write(dst: str, write_fn) -> None:
    tmp = dst + ".tmp"
    write_fn(tmp)
    os.replace(tmp, dst)


def save_checkpoint(bundle: Dict[str, Any], is_best: bool,
                    output_dir: str = "./", filename: str = CKPT_NAME,
                    meta: Optional[Dict[str, Any]] = None) -> str:
    """torch.save ``bundle`` into output_dir/filename; copy it to
    model_best on improvement (reference utils.py:17-24; the caller
    decides ``is_best`` by AP50)."""
    os.makedirs(output_dir, exist_ok=True)
    path = os.path.join(output_dir, filename)
    _atomic_write(path, lambda p: torch.save(bundle, p))
    if meta is not None:
        def write_meta(p):
            with open(p, "w") as f:
                json.dump(meta, f, indent=2, default=float)
        _atomic_write(path + META_SUFFIX, write_meta)
    if is_best:
        best = os.path.join(output_dir, BEST_NAME)
        _atomic_write(best, lambda p: shutil.copyfile(path, p))
        if meta is not None:
            _atomic_write(best + META_SUFFIX,
                          lambda p: shutil.copyfile(path + META_SUFFIX, p))
    return path


def load_checkpoint_raw(path: str) -> Dict[str, Any]:
    """What a resume reads, on the CPU: a bundle written by
    save_checkpoint, or a JAX package ``.ckpt`` as its raw tree (HWIO
    kernels, optax's ``opt_state``) tagged with ``"layout": "jax"``."""
    if str(path).endswith(".ckpt"):
        raw = dict(load_jax_checkpoint(path))
        raw[LAYOUT_KEY] = JAX_LAYOUT
        return raw
    return torch_load(path)


def is_jax_layout(raw: Any) -> bool:
    """True for a JAX package ``.ckpt`` read by load_checkpoint_raw."""
    return isinstance(raw, dict) and raw.get(LAYOUT_KEY) == JAX_LAYOUT


def load_pretrained_backbone(model: nn.Module, path: str) -> None:
    """Load the ``backbone.*`` weights of a checkpoint into ``model``'s
    backbone with a strict load: a port checkpoint or state dict, a
    reference classifier/detector ``.pth.tar`` (DDP ``module.`` prefixes
    stripped), or a JAX package ``.ckpt`` (the ``backbone`` subtree of its
    variables, or of the file itself)."""
    if str(path).endswith(".ckpt"):
        raw = load_jax_checkpoint(path)
        tree = raw.get("variables", raw)
        sd = state_dict_from_jax({
            coll: {"backbone": tree[coll]["backbone"]}
            for coll in ("params", "batch_stats")
            if "backbone" in tree.get(coll, {})})
    else:
        sd = load_weights(path)
    backbone = {k[len("backbone."):]: v for k, v in sd.items()
                if k.startswith("backbone.")}
    if not backbone:
        raise ValueError(f"{path}: no backbone.* weights")
    model.backbone.load_state_dict(backbone, strict=True)
