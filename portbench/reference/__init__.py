"""The plain reference: YOLOv4 and the CSPDarknet53 classifier, their
decode, postprocess, loss and Adam, in plain PyTorch. It imports nothing of
the program under test and takes nothing the program made.

A configuration file names its reference module, ``"reference":
"portbench/reference/<name>.py"``, and every part of the harness builds
the model through it (``module``, ``build``). A reference module defines:

* ``build(kind, n_classes, width, depth)``: the float32 model of the
  configuration's ``model`` kind, its ``state_dict`` in the program's keys
  (the train reference sets its ``checkpointed`` to recompute each stage
  in the backward);
* ``calibrate_bn(model, x)``: one eval forward that sets each BatchNorm's
  running statistics from ``x``;
* ``precision(model, mode)``: ``"float32"`` (the reference) or ``"fp8"``
  (the training control);
* ``model_input(kind, images)``: an NHWC batch to the model's input;
* ``loss(kind, out, labels)``: the train step's loss of the model's
  train-mode output.

A new architecture is a new module here that imports ``model.py``'s
layers; no file of the harness names it.
"""

from __future__ import annotations

import importlib
import os
import posixpath
from types import ModuleType
from typing import Dict, Optional

from torch import nn

CONTRACT = ("build", "calibrate_bn", "precision", "model_input", "loss")

# the directory that holds the package portbench/
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def module(config: Dict) -> ModuleType:
    """The reference module that the configuration's ``reference`` path
    names, imported under its dotted name, so that every caller shares one
    module object."""
    path = config.get("reference")
    if not isinstance(path, str) or not path:
        raise ValueError(f"configuration {config.get('name')!r} names no "
                         f"reference module (key 'reference')")
    # normpath leaves a "..", or the empty name of a leading "/", first
    norm = posixpath.normpath(path)
    parts = norm.split("/")
    if parts[0] != "portbench" or not norm.endswith(".py"):
        raise ValueError(f"reference {path!r} is not a .py file under "
                         f"portbench/")
    if not os.path.isfile(os.path.join(_ROOT, *parts)):
        raise ValueError(f"reference {path!r}: no such file")
    mod = importlib.import_module(".".join(parts)[:-len(".py")])
    missing = [name for name in CONTRACT
               if not callable(getattr(mod, name, None))]
    if missing:
        raise ValueError(f"reference {path!r} lacks {', '.join(missing)}")
    return mod


def build(config: Dict, width: Optional[float] = None,
          depth: Optional[float] = None) -> nn.Module:
    """The configuration's reference model, at the file's own ``width``
    and ``depth`` (or 1.0) unless given."""
    if width is None:
        width = config.get("width", 1.0)
    if depth is None:
        depth = config.get("depth", 1.0)
    return module(config).build(config["model"], int(config["n_classes"]),
                                width, depth)
