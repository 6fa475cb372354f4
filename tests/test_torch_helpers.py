"""Shared fixtures-by-function for the PyTorch port's tests (no tests here).

The port is held against the JAX package on the CPU: the same numpy-drawn
inputs and the same weights go through both. Weights start from the JAX
package's ``init_variables`` and are then re-drawn with numpy where the
reference init would make the comparison vacuous: with BN scales ~N(0,
0.01) every activation decays to ~0 within a few layers, every head output
is ~its zero bias, and every score is ~0.25, so neither forward nor
postprocess order would be tested.
"""

from __future__ import annotations

import jax
import numpy as np
import torch

from yolov4_tpu.config import Config as JaxConfig
from yolov4_tpu.models import build_model as jax_build_model
from yolov4_tpu.models.yolov4 import init_variables
from yolov4_tpu.utils.torch_convert import export_state_dict

from yolov4_tpu_torch.config import Config
from yolov4_tpu_torch.utils.convert import state_dict_from_jax

SMALL_CFG = {
    "MODEL": {"WIDTH": 0.25, "DEPTH": 0.25, "COMPUTE_DTYPE": "float32"},
    "TEST": {"IMGSIZE": 64},
}


def small_cfgs(extra_test=None):
    """(JAX config, port config) for the WIDTH = DEPTH = 0.25 f32 model."""
    raw = {k: dict(v) for k, v in SMALL_CFG.items()}
    raw["TEST"].update(extra_test or {})
    return JaxConfig.from_dict(raw), Config.from_dict(raw)


def spread_variables(variables, seed: int, head_scale: float = 1.0):
    """Re-draw BN affine/statistics and conv biases with numpy so that
    activations stay O(1) through the network: BN scale U(0.5, 0.8), bias
    U(-0.2, 0.2), running mean N(0, 0.1), running var U(0.5, 0.8); the
    head's output convs get biases U(-4, 1), which spreads obj and class
    scores across channels, and kernels scaled by ``head_scale``."""
    rng = np.random.default_rng(seed)

    def walk(tree, collection, name=""):
        out = {}
        for key, value in tree.items():
            if isinstance(value, dict):
                out[key] = walk(value, collection, key)
                continue
            arr = np.asarray(value, np.float32)
            shape = arr.shape
            if collection == "params" and name == "norm" and key == "scale":
                arr = rng.uniform(0.5, 0.8, shape)
            elif collection == "params" and name == "norm" and key == "bias":
                arr = rng.uniform(-0.2, 0.2, shape)
            elif collection == "params" and key == "bias":
                arr = rng.uniform(-4.0, 1.0, shape)
            elif collection == "params" and key == "kernel" and arr.shape[-1] == 255:
                arr = arr * head_scale
            elif collection == "batch_stats" and key == "mean":
                arr = rng.normal(0.0, 0.1, shape)
            elif collection == "batch_stats" and key == "var":
                arr = rng.uniform(0.5, 0.8, shape)
            out[key] = np.asarray(arr, np.float32)
        return out

    return {c: walk(t, c) for c, t in variables.items()}


def small_model_pair(seed: int = 0, img_size: int = 64,
                     head_scale: float = 1.0):
    """(jax_cfg, port_cfg, jax_model, jax_variables, port_state_dict)."""
    jcfg, cfg = small_cfgs()
    jmodel = jax_build_model(jcfg)
    jvars = init_variables(jmodel, jax.random.PRNGKey(0), img_size)
    jvars = spread_variables(jax.device_get(jvars), seed, head_scale)
    return jcfg, cfg, jmodel, jvars, state_dict_from_jax(jvars)


def export_keys(variables):
    return set(export_state_dict(variables))


def nchw(x_nhwc: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x_nhwc.transpose(0, 3, 1, 2)))
