"""The port's YOLOv4 (WIDTH = DEPTH = 0.25, float32, 64x64) against the JAX
package's, on the same weights and inputs, plus the decode goldens; and
the bfloat16 eval model, whose BatchNorm stays float32 as the JAX
package's ``param_dtype`` does."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_helpers import (export_keys, nchw, small_cfgs,
                                      small_model_pair)
from yolov4_tpu.config import DEFAULTS
from yolov4_tpu.models import build_model as jax_build_model
from yolov4_tpu_torch.models import build_model
from yolov4_tpu_torch.models.decode import decode_layer, masked_anchors
from yolov4_tpu_torch.utils.convert import state_dict_from_jax

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


def _bn_tensors(model):
    return {name: t for m_name, m in model.named_modules()
            if isinstance(m, torch.nn.BatchNorm2d)
            for name, t in ((f"{m_name}.{n}", t) for n, t in
                            (*m.named_parameters(), *m.named_buffers()))}


def test_bfloat16_model_keeps_batchnorm_float32():
    _, cfg = small_cfgs()
    cfg["MODEL"]["COMPUTE_DTYPE"] = "bfloat16"
    model = build_model(cfg, device="cpu")
    bn = _bn_tensors(model)
    n_bn = sum(isinstance(m, torch.nn.BatchNorm2d) for m in model.modules())
    assert n_bn > 50 and len(bn) == 5 * n_bn
    for name, t in bn.items():
        want = torch.int64 if name.endswith("num_batches_tracked") \
            else torch.float32
        assert t.dtype == want, name
    assert model.backbone.stage2.base.conv.weight.dtype == torch.bfloat16
    # a float32 state_dict loads into BN unrounded (1 + 2^-12 is no
    # bfloat16 value)
    sd = {k: torch.full_like(v, 1 + 2 ** -12, dtype=torch.float32)
          if v.is_floating_point() else v
          for k, v in model.state_dict().items()}
    model.load_state_dict(sd)
    for name, t in _bn_tensors(model).items():
        assert t.dtype == bn[name].dtype, name
        if t.is_floating_point():
            assert torch.equal(t, sd[name]), name


def _shift_bn(variables, seed, lo=20.0, hi=60.0):
    """Each BN's running mean moved by +-U(lo, hi), its bias by the same
    amount in output units: the float32 network computes the same
    function, with |mean| >> std (var is O(1)) everywhere."""
    rng = np.random.default_rng(seed)

    def walk(params, stats):
        for key, sub in params.items():
            if key == "norm":
                shape = sub["scale"].shape
                d = rng.uniform(lo, hi, shape) * rng.choice([-1, 1], shape)
                std = np.sqrt(np.asarray(stats[key]["var"], np.float64)
                              + 1e-5)
                stats[key]["mean"] = np.asarray(stats[key]["mean"] + d,
                                                np.float32)
                sub["bias"] = np.asarray(sub["bias"] + d * sub["scale"] / std,
                                         np.float32)
            elif isinstance(sub, dict) and key in stats:
                walk(sub, stats[key])

    walk(variables["params"], variables["batch_stats"])
    return variables


def test_bfloat16_eval_forward_no_further_from_float32_than_jax(models):
    """With BN statistics far from 0 (|mean| >> std), rounding them to
    bfloat16 moves the normalized output by several standard deviations;
    the JAX package normalizes with float32 statistics. The port's
    bfloat16 forward is held against its float32 forward and must stay
    within 1.5x of the JAX package's distance between the same two."""
    import copy
    jvars = _shift_bn(copy.deepcopy(models["jvars"]), 1)
    x = jnp.asarray(models["x"])
    j32 = np.asarray(models["apply"](jvars, x, True))
    jcfg, cfg = small_cfgs()
    jcfg["MODEL"]["COMPUTE_DTYPE"] = "bfloat16"
    jmodel16 = jax_build_model(jcfg)
    j16 = np.asarray(jax.jit(lambda v, x: jmodel16.apply(v, x, train=False))(
        jvars, x), np.float32)
    sd = state_dict_from_jax(jvars)
    outs = {}
    for dtype in ("float32", "bfloat16"):
        cfg["MODEL"]["COMPUTE_DTYPE"] = dtype
        model = build_model(cfg, device="cpu")
        model.load_state_dict(sd)
        with torch.no_grad():
            outs[dtype] = model.eval()(nchw(models["x"])).float().numpy()
    np.testing.assert_allclose(outs["float32"], j32, atol=2e-3, rtol=1e-3)
    for cols in (slice(0, 4), slice(4, None)):          # boxes, scores
        jax_err = np.abs(j16 - j32)[..., cols].mean()
        port_err = np.abs(outs["bfloat16"] - outs["float32"])[..., cols].mean()
        assert 0 < port_err <= 1.5 * jax_err, (cols, port_err, jax_err)
