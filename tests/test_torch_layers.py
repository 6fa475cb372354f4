"""The port's building blocks against the reference goldens and the JAX
package's activation."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolov4_tpu.models.layers import mish as jax_mish
from yolov4_tpu_torch.models.layers import (ConvBNAct, CSPDownSample,
                                            CSPDownSample0, mish)

torch.set_num_threads(1)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")


def _golden(name):
    return np.load(os.path.join(GOLDEN_DIR, f"block_{name}.npz"))


@pytest.mark.parametrize("name,kind,kwargs", [
    ("convbnact_mish", "conv", dict(kernel_size=3, stride=1, act="mish")),
    ("convbnact_stride2", "conv",
     dict(kernel_size=3, stride=2, act="leaky_relu")),
    ("convbnact_bias_linear", "conv",
     dict(kernel_size=1, stride=1, bias=True, bn=False, act="linear")),
    ("csp0", "csp0", dict()),
    ("csp", "csp", dict(num_blocks=2)),
])
def test_block_goldens(name, kind, kwargs):
    """The reference's stored state_dicts (``sd/``) load directly, and the
    outputs match the reference's at the JAX package's golden tolerances
    (tests/test_goldens.py)."""
    golden = _golden(name)
    x = torch.from_numpy(golden["x"])
    out_ch = golden["y"].shape[1]
    if kind == "conv":
        module = ConvBNAct(x.shape[1], out_ch, **kwargs)
    elif kind == "csp0":
        module = CSPDownSample0(x.shape[1], out_ch, 3, 2, act="mish")
    else:
        module = CSPDownSample(x.shape[1], out_ch, 3, 2, act="mish", **kwargs)
    sd = {k[len("sd/"):]: torch.from_numpy(np.asarray(golden[k]))
          for k in golden.files if k.startswith("sd/")}
    module.load_state_dict(sd)  # strict: keys are the reference's
    module.eval()
    with torch.no_grad():
        y = module(x).numpy()
    np.testing.assert_allclose(y, golden["y"], atol=2e-5, rtol=1e-4)


def test_mish_matches_jax_formula():
    """Same algebraic formula as the JAX package, including the x > 20
    asymptote and the far negative tail."""
    x = np.concatenate([
        np.linspace(-60.0, 60.0, 4001, dtype=np.float32),
        np.array([-1e4, -88.0, -20.5, -20.0, 19.999, 20.0, 20.001, 25.0,
                  1e4], np.float32)])
    got = mish(torch.from_numpy(x)).numpy()
    want = np.asarray(jax_mish(jnp.asarray(x)))
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    big = x > 20
    np.testing.assert_array_equal(got[big], x[big])
