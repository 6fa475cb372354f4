"""Weights in and out of the port.

The port's module tree carries the reference torch tree's names, so a
reference ``.pth.tar`` (or any state_dict saved from the port) loads with
plain ``load_state_dict``. This module adds:

  * ``state_dict_from_jax``: the JAX package's {'params', 'batch_stats'}
    nested dicts -> the port's state_dict. The port's own copy of the
    mapping in the JAX package's utils/torch_convert.py (``_split_module``,
    ``flax_path_to_torch_key``, ``export_state_dict``): flax module names
    split back into torch Sequential indices, conv kernels HWIO -> OIHW,
    ``scale`` -> ``weight``, ``mean``/``var`` -> ``running_mean``/
    ``running_var``, plus ``num_batches_tracked`` = 0 for each BatchNorm
    so that a strict load succeeds;
  * ``load_jax_checkpoint``, ``jax_variables``: a JAX package ``.ckpt``
    (flax msgpack, read by the port's own decoder, utils/msgpack.py) and
    its model variables {'params', 'batch_stats'}, where the JAX
    package's ``load_variables`` finds them;
  * ``load_weights``: a ``.pth``/``.pth.tar``/``.pt``/``.npz``/``.ckpt``
    file -> a state_dict of tensors, with a DDP ``module.`` prefix
    stripped;
  * ``torch_load``: ``torch.load(weights_only=True)`` that also lets numpy
    scalars and dtypes through (the reference trainer's wrapper stores
    COCOeval's numpy float64 APs beside the weights) and names the global
    it refuses otherwise.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Tuple

import pickle

import numpy as np
import torch

from yolov4_tpu_torch.utils.msgpack import msgpack_restore

Path = Tuple[str, ...]

# torch attribute names that natively contain ``_<digit>`` (their
# underscores are not Sequential indices). part2_* only behaves this way
# inside CSPDownSample0, i.e. under a 'stage1' parent (reference
# darknet/darknet.py:84-113); elsewhere part2 is a Sequential.
_STAGE1_ATOMICS = ("part2_1_2", "part2_1_1", "part2_2")
_GLOBAL_ATOMICS = ("module_list",)


def _split_module(module: str, in_stage1: bool) -> list:
    atomics = (_STAGE1_ATOMICS if in_stage1 else ()) + _GLOBAL_ATOMICS
    for atomic in atomics:
        if module == atomic:
            return [atomic]
        if module.startswith(atomic + "_"):
            rest = module[len(atomic) + 1:].split("_")
            if not all(seg.isdigit() for seg in rest):
                raise ValueError(f"unexpected module name {module!r}")
            return [atomic] + rest
    parts = module.split("_")
    tail: list = []
    while parts and parts[-1].isdigit():
        tail.insert(0, parts.pop())
    return (["_".join(parts)] if parts else []) + tail


def flax_path_to_torch_key(collection: str, path: Path) -> str:
    """``('neck', 'spp', 'conv1_0', 'conv', 'kernel')`` in 'params' ->
    ``neck.spp.conv1.0.conv.weight``."""
    *modules, leaf = path
    segments: list = []
    in_stage1 = False
    for module in modules:
        segments.extend(_split_module(module, in_stage1))
        in_stage1 = in_stage1 or module == "stage1"
    if collection == "batch_stats":
        leaf_name = {"mean": "running_mean", "var": "running_var"}[leaf]
    else:
        leaf_name = {"kernel": "weight", "scale": "weight", "bias": "bias"}[leaf]
    return ".".join(segments + [leaf_name])


def state_dict_from_jax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """{'params', 'batch_stats'} pytrees of arrays -> the port's
    state_dict (float32 tensors on the CPU)."""
    out: Dict[str, torch.Tensor] = {}

    def walk(collection, tree, prefix: Path):
        for key, value in tree.items():
            if isinstance(value, Mapping):
                walk(collection, value, prefix + (key,))
                continue
            if isinstance(value, torch.Tensor):  # a bfloat16 leaf
                value = value.float().numpy()
            arr = np.asarray(value, dtype=np.float32)
            if key == "kernel":
                if arr.ndim == 4:
                    arr = np.transpose(arr, (3, 2, 0, 1))  # HWIO -> OIHW
                elif arr.ndim == 2:
                    arr = np.transpose(arr, (1, 0))
            name = flax_path_to_torch_key(collection, prefix + (key,))
            out[name] = torch.from_numpy(np.ascontiguousarray(arr))
            if collection == "batch_stats" and key == "mean":
                stem = name[:-len("running_mean")]
                out[stem + "num_batches_tracked"] = torch.tensor(0)

    for collection in ("params", "batch_stats"):
        if collection in variables:
            walk(collection, variables[collection], ())
    return out


def _strip_ddp(state_dict: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    return {(k[len("module."):] if k.startswith("module.") else k):
            torch.as_tensor(v) for k, v in state_dict.items()}


def _numpy_globals() -> List:
    """What unpickling a numpy scalar needs: ``multiarray.scalar`` (under
    numpy 1's and numpy 2's module names), ``np.dtype`` and the dtype
    classes of the scalar types a wrapper holds."""
    core = getattr(np, "_core", None) or np.core
    scalar = core.multiarray.scalar
    kinds = (np.float64, np.float32, np.int64, np.int32, np.bool_)
    return ([(scalar, "numpy.core.multiarray.scalar"),
             (scalar, "numpy._core.multiarray.scalar"), np.dtype]
            + [type(np.dtype(k)) for k in kinds])


def torch_load(path: str) -> Any:
    """``torch.load(path, weights_only=True)`` on the CPU, with numpy
    scalars and dtypes allowed. Any other non-tensor global is refused
    with an error that names the file and the global."""
    try:
        with torch.serialization.safe_globals(_numpy_globals()):
            return torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as err:
        allowed = {"numpy.core.multiarray.scalar",
                   "numpy._core.multiarray.scalar", "numpy.dtype"}
        try:
            names = [g for g in torch.serialization
                     .get_unsafe_globals_in_checkpoint(path)
                     if g not in allowed and not g.startswith("numpy.dtypes.")]
        except Exception:  # noqa: BLE001 - the listing is only a hint
            names = []
        raise ValueError(
            f"{path}: torch.load(weights_only=True) refuses the global "
            f"{', '.join(names) if names else err}; only tensors, "
            "containers, Python scalars and numpy scalars load") from None


def load_jax_checkpoint(path: str) -> Dict[str, Any]:
    """A JAX package ``.ckpt`` (utils/checkpoint.save_checkpoint there) as
    nested dicts of numpy arrays (bfloat16 leaves as torch tensors)."""
    with open(path, "rb") as f:
        raw = msgpack_restore(f.read())
    if not isinstance(raw, Mapping):
        raise ValueError(f"{path}: not a JAX package checkpoint")
    return raw


def jax_variables(raw: Mapping[str, Any], path: str = "") -> Dict[str, Any]:
    """The model variables of a loaded JAX checkpoint: its ``variables``
    (a trainer bundle, EMA weights when it kept an EMA) or its top-level
    ``params``/``batch_stats`` (the JAX package's ``load_variables``)."""
    if "variables" in raw:
        return raw["variables"]
    if "params" in raw:
        return {k: raw[k] for k in ("params", "batch_stats") if k in raw}
    raise ValueError(f"{path}: unrecognised checkpoint layout: "
                     f"{list(raw)[:8]}")


def load_weights(path: str) -> Dict[str, torch.Tensor]:
    """Read a weights file into a state_dict of CPU tensors.

    ``.ckpt``: a JAX package checkpoint, mapped by
    ``state_dict_from_jax``. ``.npz``: every array is one entry, keyed by
    its name. Otherwise a
    ``torch.save`` file: a bare state_dict, the reference trainer's
    ``{epoch, state_dict, ...}`` wrapper (utils.py:17-24) or the port
    trainer's ``{variables, opt_state, meta, ...}`` bundle
    (utils/checkpoint.py), read by ``torch_load``. A leading DDP
    ``module.`` prefix is stripped.
    """
    if str(path).endswith(".ckpt"):
        return state_dict_from_jax(jax_variables(load_jax_checkpoint(path),
                                                 path))
    if str(path).endswith(".npz"):
        with np.load(path) as blob:
            return _strip_ddp({k: blob[k] for k in blob.files})
    blob = torch_load(path)
    for key in ("state_dict", "variables"):
        if isinstance(blob, Mapping) and isinstance(blob.get(key), Mapping):
            blob = blob[key]
    if not isinstance(blob, Mapping):
        raise ValueError(f"{path}: no state_dict found")
    return _strip_ddp({k: v for k, v in blob.items()
                       if isinstance(v, torch.Tensor)})
