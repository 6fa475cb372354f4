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
  * ``opt_state_from_jax``: the JAX package's optax state (a ``.ckpt``'s
    ``opt_state``) -> a ``torch.optim`` state dict for the port's Adam or
    SGD, and ``bundle_from_jax``: a JAX trainer's ``.ckpt`` -> the port's
    resume bundle (utils/checkpoint.py);
  * ``quant_state_from_jax``: the JAX package's int8_static "quant"
    collection -> an int8_static state a Predictor keeps (its
    ``quant_state``);
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


def flax_module_to_torch(modules: Path) -> str:
    """``('neck', 'spp', 'conv1_0')`` -> ``neck.spp.conv1.0``."""
    segments: list = []
    in_stage1 = False
    for module in modules:
        segments.extend(_split_module(module, in_stage1))
        in_stage1 = in_stage1 or module == "stage1"
    return ".".join(segments)


def flax_path_to_torch_key(collection: str, path: Path) -> str:
    """``('neck', 'spp', 'conv1_0', 'conv', 'kernel')`` in 'params' ->
    ``neck.spp.conv1.0.conv.weight``."""
    *modules, leaf = path
    prefix = flax_module_to_torch(tuple(modules))
    if collection == "batch_stats":
        leaf_name = {"mean": "running_mean", "var": "running_var"}[leaf]
    else:
        leaf_name = {"kernel": "weight", "scale": "weight", "bias": "bias"}[leaf]
    return ".".join(([prefix] if prefix else []) + [leaf_name])


def quant_state_from_jax(quant: Mapping[str, Any], model) -> Dict[
        str, Dict[str, torch.Tensor]]:
    """The JAX package's int8_static "quant" collection -> {site: {amax,
    wq, sw}} for ``model``'s int8 sites (what ``Predictor.quant_state``
    takes).

    Each site keeps its calibrated ``amax``. Its ``wq`` (HWIO -> the
    port's OHWI) and ``sw`` come across where the JAX layer ran the plain
    conv; a rearranged layout (the s2d stem and stage-1 base conv, WPACK's
    packed convs: another kernel shape) keeps ``amax`` only and the weights
    are quantized again from ``model``'s, which gives the same integers
    (the rearranged taps are copies of the plain ones). The link scales
    (``link_*``, QUANT_CHAIN) are dropped: the chained program gives the
    unchained one's outputs bit for bit, and each consumer's own ``amax``
    holds the same value."""
    from yolov4_tpu_torch.models.layers import ConvBNAct
    sites = {m.quant_site: m for m in model.modules()
             if isinstance(m, ConvBNAct) and m.quant != "none"}
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    refolded = []

    def tensor(value, dtype):
        if isinstance(value, torch.Tensor):
            value = value.float().numpy()
        return torch.from_numpy(np.ascontiguousarray(
            np.asarray(value).astype(dtype)))

    def walk(tree, prefix: Path):
        if "amax" in tree and "wq" in tree:
            name = flax_module_to_torch(prefix)
            if name not in sites:
                raise ValueError(f"JAX quant site {'/'.join(prefix)} "
                                 f"({name}) is not an int8 site of the model")
            m = sites[name]
            wq = tensor(tree["wq"], np.int8)
            amax = tensor(tree["amax"], np.float32).reshape(())
            want = (m.conv.out_channels, m.conv.in_channels,
                    *m.conv.kernel_size)
            if wq.dim() == 4 and (wq.shape[3], wq.shape[2], wq.shape[0],
                                  wq.shape[1]) == want:
                out[name] = dict(amax=amax,
                                 wq=wq.permute(3, 0, 1, 2).contiguous(),
                                 sw=tensor(tree["sw"], np.float32))
            else:
                wq, sw, _ = m.quantized_weights()
                out[name] = dict(amax=amax, wq=wq.cpu(), sw=sw.cpu())
                refolded.append(name)
            return
        for key, value in tree.items():
            if isinstance(value, Mapping):
                walk(value, prefix + (key,))

    walk(quant, ())
    missing = sorted(set(sites) - set(out))
    if missing:
        raise ValueError(f"the JAX quant collection lacks {len(missing)} "
                         f"int8 site(s) of the model, e.g. {missing[:3]}")
    if refolded:
        from yolov4_tpu_torch.utils.logging import get_logger
        get_logger(__name__).info(
            f"quant_state_from_jax: {len(refolded)} site(s) in a rearranged "
            f"TPU layout ({', '.join(refolded)}): amax carried, weights "
            "quantized again from the model's")
    return out


def _leaves(tree: Mapping[str, Any], prefix: Path = ()):
    """(path, leaf) of a nested-dict pytree, depth first in key order."""
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _leaf_to_torch(path: Path, value) -> torch.Tensor:
    """One array of a JAX tree as a float32 CPU tensor in the port's
    layout: a 4-D ``kernel`` HWIO -> OIHW, a 2-D (Dense) one transposed."""
    if isinstance(value, torch.Tensor):  # a bfloat16 leaf
        value = value.float().numpy()
    arr = np.asarray(value, dtype=np.float32)
    if path[-1] == "kernel":
        if arr.ndim == 4:
            arr = np.transpose(arr, (3, 2, 0, 1))  # HWIO -> OIHW
        elif arr.ndim == 2:
            arr = np.transpose(arr, (1, 0))
    return torch.from_numpy(np.ascontiguousarray(arr))


def state_dict_from_jax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """{'params', 'batch_stats'} pytrees of arrays -> the port's
    state_dict (float32 tensors on the CPU)."""
    out: Dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats"):
        for path, value in _leaves(variables.get(collection, {})):
            name = flax_path_to_torch_key(collection, path)
            out[name] = _leaf_to_torch(path, value)
            if collection == "batch_stats" and path[-1] == "mean":
                stem = name[:-len("running_mean")]
                out[stem + "num_batches_tracked"] = torch.tensor(0)
    return out


def _params_tree(tree: Any, params: Mapping[str, torch.Tensor],
                 what: str) -> Dict[str, torch.Tensor]:
    """A JAX tree shaped like the model's params (an optax moment or
    trace) -> {parameter name: tensor in the parameter's layout}. Raises,
    naming the path, on a leaf the model lacks, a parameter the tree
    lacks, or a shape that differs."""
    if not isinstance(tree, Mapping):
        raise ValueError(f"{what}: expected a tree of the model's "
                         f"parameters, got {type(tree).__name__}")
    out: Dict[str, torch.Tensor] = {}
    for path, value in _leaves(tree):
        where = f"{what}/{'/'.join(path)}"
        try:
            name = flax_path_to_torch_key("params", path)
        except (KeyError, ValueError):
            raise ValueError(f"{where}: not a parameter leaf") from None
        if name not in params:
            raise ValueError(f"{where} ({name}): the model has no such "
                             "parameter")
        t = _leaf_to_torch(path, value)
        if t.shape != params[name].shape:
            raise ValueError(f"{where} ({name}): shape {tuple(t.shape)} in "
                             f"the file, {tuple(params[name].shape)} in the "
                             "model")
        out[name] = t
    missing = [n for n in params if n not in out]
    if missing:
        raise ValueError(f"{what}: {len(missing)} parameter(s) of the model "
                         f"missing, e.g. {missing[:3]}")
    return out


def _expect_keys(tree: Any, keys, what: str, kind: str) -> None:
    got = sorted(tree) if isinstance(tree, Mapping) else type(tree).__name__
    if got != sorted(keys):
        raise ValueError(
            f"{what}: the port's {kind} needs optax's state with the keys "
            f"{sorted(keys)}, the file holds {got} (another optimizer's "
            "state, or a truncated one)")


def param_names_in_order(optimizer: torch.optim.Optimizer,
                         model: torch.nn.Module) -> List[str]:
    """``model``'s parameter names in the order of
    ``optimizer.param_groups``: the indices of its state dict."""
    names = {id(p): n for n, p in model.named_parameters()}
    return [names[id(p)] for g in optimizer.param_groups
            for p in g["params"]]


def opt_state_from_jax(opt_state: Mapping[str, Any],
                       optimizer: torch.optim.Optimizer,
                       model: torch.nn.Module) -> Dict[str, Any]:
    """The optax state of a JAX package ``.ckpt`` -> a dict shaped like
    ``optimizer.state_dict()`` (pass it to ``optimizer.load_state_dict``,
    which moves each tensor to its parameter's device and dtype).

    The JAX package's ADAM is ``optax.scale_by_adam(0.9, 0.999, 1e-8)``,
    whose state ``ScaleByAdamState(count, mu, nu)`` the file holds as
    ``{"count", "mu", "nu"}``: every parameter gets ``step = count``,
    ``exp_avg = mu`` and ``exp_avg_sq = nu`` (both rules correct the bias
    by the update count and add eps outside the square root). Its SGD is
    ``chain(masked add_decayed_weights, trace)``, held as ``{"0":
    {"inner_state": {}}, "1": {"trace"}}``: ``momentum_buffer = trace``.
    Each tree gets the weights' layout change and is indexed by the
    parameter's position in ``optimizer.param_groups`` (SGD's two groups
    split by the decay mask). Any other structure raises: there is no
    fallback to a fresh state."""
    params = dict(model.named_parameters())
    order = param_names_in_order(optimizer, model)
    what = "opt_state"
    if isinstance(optimizer, torch.optim.Adam):
        _expect_keys(opt_state, ("count", "mu", "nu"), what, "Adam")
        count = np.asarray(opt_state["count"])
        if count.shape != () or count.dtype.kind not in "iu":
            raise ValueError(f"{what}/count: an integer scalar expected, "
                             f"got {count.dtype} {count.shape}")
        mu = _params_tree(opt_state["mu"], params, f"{what}/mu")
        nu = _params_tree(opt_state["nu"], params, f"{what}/nu")
        state = {i: {"step": torch.tensor(float(count)),
                     "exp_avg": mu[n], "exp_avg_sq": nu[n]}
                 for i, n in enumerate(order)}
    elif isinstance(optimizer, torch.optim.SGD):
        _expect_keys(opt_state, ("0", "1"), what, "SGD")
        _expect_keys(opt_state["0"], ("inner_state",), f"{what}/0",
                     "SGD's masked weight decay")
        inner = opt_state["0"]["inner_state"]
        if not (inner is None or (isinstance(inner, Mapping) and not inner)):
            raise ValueError(f"{what}/0/inner_state: the masked weight "
                             "decay keeps no state, the file holds some")
        _expect_keys(opt_state["1"], ("trace",), f"{what}/1", "SGD momentum")
        trace = _params_tree(opt_state["1"]["trace"], params,
                             f"{what}/1/trace")
        state = {i: {"momentum_buffer": trace[n]}
                 for i, n in enumerate(order)}
    else:
        raise ValueError(f"no mapping of optax's state onto "
                         f"{type(optimizer).__name__}")
    return {"state": state,
            "param_groups": optimizer.state_dict()["param_groups"]}


def bundle_from_jax(raw: Mapping[str, Any], optimizer: torch.optim.Optimizer,
                    model: torch.nn.Module, path: str = "") -> Dict[str, Any]:
    """A JAX package trainer's ``.ckpt`` (its raw tree) -> the port's
    resume bundle (utils/checkpoint.py): ``variables`` (the EMA weights
    when the file keeps an EMA) and ``raw_params`` as state dicts,
    ``opt_state`` for ``optimizer`` where the file has one, and
    ``meta``."""
    if "variables" not in raw:
        raise ValueError(f"{path} is not a JAX package training checkpoint "
                         "(no 'variables')")
    bundle = {"variables": state_dict_from_jax(raw["variables"]),
              "meta": dict(raw.get("meta", {}))}
    if "raw_params" in raw:
        bundle["raw_params"] = _params_tree(
            raw["raw_params"], dict(model.named_parameters()), "raw_params")
    if "opt_state" in raw:
        bundle["opt_state"] = opt_state_from_jax(raw["opt_state"],
                                                 optimizer, model)
    return bundle


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
