"""The port's YOLOv4 (WIDTH = DEPTH = 0.25, float32, 64x64) against the JAX
package's, on the same weights and inputs, plus the decode goldens."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_helpers import export_keys, nchw, small_model_pair
from yolov4_tpu.config import DEFAULTS
from yolov4_tpu_torch.models import build_model
from yolov4_tpu_torch.models.decode import decode_layer, masked_anchors

torch.set_num_threads(1)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")


@pytest.fixture(scope="module")
def models():
    jcfg, cfg, jmodel, jvars, sd = small_model_pair(seed=0)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(sd)
    model.eval()
    x = np.random.default_rng(1).random((2, 64, 64, 3), dtype=np.float32)
    apply = jax.jit(lambda v, x, decode: jmodel.apply(v, x, train=False,
                                                      decode=decode),
                    static_argnums=2)
    return dict(jvars=jvars, model=model, x=x, apply=apply)


def test_state_dict_keys_match_reference_layout(models):
    """The port's keys are the reference torch tree's keys, i.e. what the
    JAX package's exporter writes for the same architecture."""
    ours = {k for k in models["model"].state_dict()
            if not k.endswith("num_batches_tracked")}
    assert ours == export_keys(models["jvars"])
    for key in ("backbone.stage1.part2_1_1.conv.weight",
                "backbone.stage2.part2.1.module_list.0.1.norm.running_var",
                "neck.spp.conv1.0.conv.weight",
                "head.yolo1.1.conv.bias"):
        assert key in ours


def test_raw_head_maps_match_jax(models):
    want = models["apply"](models["jvars"], jnp.asarray(models["x"]), False)
    with torch.no_grad():
        got = models["model"](nchw(models["x"]), decode=False)
    assert len(got) == 3
    for g, w in zip(got, want):
        w = np.asarray(w).transpose(0, 3, 1, 2)
        assert g.shape == w.shape
        # oneDNN and XLA sum the convolutions in different orders
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4, rtol=1e-4)


def test_decoded_predictions_match_jax(models):
    want = np.asarray(models["apply"](models["jvars"],
                                      jnp.asarray(models["x"]), True))
    with torch.no_grad():
        got = models["model"](nchw(models["x"])).numpy()
    assert got.shape == want.shape == (2, 252, 85)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    # the comparison is not vacuous: scores spread over (0, 1)
    assert want[..., 4:].std() > 0.05


def test_seeded_init_is_reproducible_and_reference_shaped():
    from tests.test_torch_helpers import small_cfgs
    _, cfg = small_cfgs()
    a = build_model(cfg, device="cpu",
                    generator=torch.Generator().manual_seed(3)).state_dict()
    b = build_model(cfg, device="cpu",
                    generator=torch.Generator().manual_seed(3)).state_dict()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    w = a["backbone.stage3.base.conv.weight"]  # OIHW, fan_out = O*3*3
    np.testing.assert_allclose(w.std().item(),
                               np.sqrt(2.0 / (w.shape[0] * 9)), rtol=0.05)
    assert a["backbone.stage3.base.norm.weight"].std().item() < 0.02
    assert float(a["head.yolo1.1.conv.bias"].abs().max()) == 0.0
    # bfloat16 layers, float32 anchors (459/32 is not a bfloat16 value)
    cfg["MODEL"]["COMPUTE_DTYPE"] = "bfloat16"
    bf = build_model(cfg, device="cpu")
    assert bf.backbone.stem.conv.weight.dtype == torch.bfloat16
    assert bf.anchors_grid2.dtype == torch.float32
    assert float(bf.anchors_grid2[2, 0]) == 459 / 32
    assert not any(k.startswith("anchors") for k in bf.state_dict())


@pytest.mark.parametrize("layer_no", [0, 1, 2])
def test_decode_goldens(layer_no):
    golden = np.load(os.path.join(GOLDEN_DIR, "decode_loss.npz"))
    anchors = DEFAULTS["MODEL"]["ANCHORS"]
    masks = DEFAULTS["MODEL"]["ANCHOR_MASK"]
    raw = torch.from_numpy(golden[f"raw{layer_no}"])  # NCHW, as stored
    anc = masked_anchors(anchors, masks, layer_no)
    got = decode_layer(raw, anc, layer_no, training=True)
    np.testing.assert_allclose(got["output"].numpy(),
                               golden[f"out{layer_no}"], atol=1e-5)
    np.testing.assert_allclose(got["pred"].numpy(), golden[f"pred{layer_no}"],
                               atol=1e-4, rtol=1e-5)
    got_eval = decode_layer(raw, anc, layer_no, training=False)
    np.testing.assert_allclose(got_eval.numpy(), golden[f"eval{layer_no}"],
                               atol=1e-3, rtol=1e-5)
