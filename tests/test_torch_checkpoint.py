"""The port's reader of the JAX package's ``.ckpt`` files (utils/msgpack.py,
utils/convert.load_weights, utils/checkpoint.py) against flax and the JAX
package on the CPU: files written by ``yolov4_tpu.utils.checkpoint.
save_checkpoint`` in both layouts, with a bfloat16 and a chunked leaf,
decode leaf for leaf as flax's ``msgpack_restore`` does and map to
``state_dict_from_jax``'s state dict; a Predictor on the file matches the
JAX Predictor on it; ``BACKBONE_PRETRAINED`` grafts from it; a resume
refuses an optimizer state that does not map; and none of it, a resume's
whole state included, needs flax or msgpack."""

import subprocess
import sys

import flax.serialization as flax_serialization
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.test_torch_helpers import SMALL_CFG, small_model_pair
from yolov4_tpu.engine.predictor import Predictor as JaxPredictor
from yolov4_tpu.utils import checkpoint as jax_ckpt
from yolov4_tpu_torch.engine.predictor import Predictor
from yolov4_tpu_torch.models import build_model
from yolov4_tpu_torch.optim import build_optimizer
from yolov4_tpu_torch.utils import msgpack
from yolov4_tpu_torch.utils.checkpoint import (is_jax_layout,
                                               load_checkpoint_raw,
                                               load_pretrained_backbone)
from yolov4_tpu_torch.utils.convert import (bundle_from_jax,
                                            load_jax_checkpoint,
                                            load_weights, state_dict_from_jax)

torch.set_num_threads(1)

SLICE_TEST = {"PRE_NMS_TOPK": 64, "MAX_DETS": 50, "CONFTHRE": 0.05,
              "NMSTHRE": 0.45}


@pytest.fixture(scope="module")
def pair():
    # seed 9 / head_scale 0.5: the weights tests/test_torch_predictor.py
    # shows to separate every score order beyond the forward difference
    jcfg, cfg, jmodel, jvars, sd = small_model_pair(seed=9, head_scale=0.5)
    for c in (jcfg, cfg):
        c["TEST"].update(SLICE_TEST)
    return dict(jcfg=jcfg, cfg=cfg, jvars=jvars, sd=sd)


def _assert_same_tree(want, got, path=""):
    """flax's restored tree against the port's, leaf for leaf: equal
    values, dtypes and types (bfloat16 leaves as torch bfloat16)."""
    if isinstance(want, dict):
        assert set(want) == set(got), path
        for key in want:
            _assert_same_tree(want[key], got[key], f"{path}/{key}")
    elif isinstance(want, (list, tuple)):
        assert len(want) == len(got), path
        for w, g in zip(want, got):
            _assert_same_tree(w, g, path)
    elif isinstance(got, torch.Tensor):
        assert got.dtype == torch.bfloat16, path
        np.testing.assert_array_equal(np.asarray(want, np.float32),
                                      got.float().numpy(), err_msg=path)
    elif isinstance(want, np.ndarray):
        assert want.dtype == got.dtype and want.shape == got.shape, path
        np.testing.assert_array_equal(want, got, err_msg=path)
    else:
        assert type(want) is type(got) and want == got, (path, want, got)


def test_decoder_matches_flax_on_every_type(monkeypatch):
    rng = np.random.default_rng(0)
    tree = {
        "f32": rng.random((3, 4)).astype(np.float32),
        "i": [0, 127, 128, -1, -32, -33, 255, 65536, -70000, 2 ** 40,
              -(2 ** 40), 2 ** 63 + 5],
        "misc": [1.5, None, True, False, "héllo", "x" * 300,
                 b"\x00\x01"],
        "scalars": {"f": np.float32(2.5), "i": np.int64(7),
                    "bf": jnp.bfloat16(1.5)},
        "bf16": np.asarray(jnp.arange(6, dtype=jnp.bfloat16).reshape(2, 3)),
        "wide": {str(i): np.full((i,), i, np.int32) for i in range(20)},
        "u8": np.arange(5, dtype=np.uint8),
        "empty": np.zeros((0, 3), np.float32),
        "f64": np.linspace(0, 1, 7),
        "big": rng.random(70000).astype(np.float32),
        "bigbf": np.asarray(jnp.asarray(rng.random((300, 7)), jnp.bfloat16)),
    }
    # chunk every leaf above 1000 bytes, as flax does above 2**30
    monkeypatch.setattr(flax_serialization, "MAX_CHUNK_SIZE", 1000)
    data = flax_serialization.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in data
    _assert_same_tree(flax_serialization.msgpack_restore(data),
                      msgpack.msgpack_restore(data))
    with pytest.raises(ValueError, match="ends inside"):
        msgpack.unpackb(data[:-3])
    with pytest.raises(ValueError, match="trailing"):
        msgpack.unpackb(data + b"\x00")
    with pytest.raises(ValueError, match="marker 0xc1"):
        msgpack.unpackb(b"\xc1")


def _with_bf16_leaf(tree):
    """A copy of ``tree`` whose first leaf (in sorted key order) is
    bfloat16."""
    key = sorted(tree)[0]
    value = tree[key]
    leaf = (_with_bf16_leaf(value) if isinstance(value, dict)
            else jnp.asarray(value, jnp.bfloat16))
    return dict(tree, **{key: leaf})


def _bundle(variables):
    """A JAX trainer-shaped bundle: variables, optimizer state, meta."""
    return {"variables": variables,
            "opt_state": {"mu": {"w": np.ones(3, np.float32)},
                          "count": np.int32(4)},
            "meta": {"epoch": 3, "best_ap50": 0.25}}


@pytest.mark.parametrize("layout", ["variables", "params"])
def test_ckpt_loads_to_state_dict_from_jax(pair, tmp_path, layout,
                                           monkeypatch):
    jvars = pair["jvars"]
    # one bfloat16 leaf (the first of the head) and, with a small chunk
    # limit, chunked leaves
    tree = {"params": _with_bf16_leaf(jvars["params"]["head"]),
            "batch_stats": jvars["batch_stats"]}
    tree["params"] = dict(jvars["params"], head=tree["params"])
    state = _bundle(tree) if layout == "variables" else tree
    monkeypatch.setattr(flax_serialization, "MAX_CHUNK_SIZE", 1 << 16)
    path = jax_ckpt.save_checkpoint(state, False, output_dir=str(tmp_path),
                                    filename="m.ckpt")
    with open(path, "rb") as f:
        assert b"__msgpack_chunked_array__" in f.read()
    _assert_same_tree(jax_ckpt.load_checkpoint_raw(path),
                      load_jax_checkpoint(path))
    want = state_dict_from_jax(jax_ckpt.load_variables(path))
    got = load_weights(path)
    assert set(got) == set(want) == set(pair["sd"])
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert torch.equal(got[key], want[key]), key
    bf_key = next(k for k in got if k.startswith("head.") and
                  not torch.equal(got[k], pair["sd"][k]))
    assert torch.equal(got[bf_key],
                       pair["sd"][bf_key].bfloat16().float())


def test_predictor_on_ckpt_matches_jax_predictor(pair, tmp_path):
    path = jax_ckpt.save_checkpoint(_bundle(pair["jvars"]), False,
                                    output_dir=str(tmp_path),
                                    filename="model_best.ckpt")
    images = np.random.default_rng(2).integers(0, 256, (2, 64, 64, 3),
                                               dtype=np.uint8)
    jdet, jvalid = JaxPredictor(pair["jcfg"],
                                variables=jax_ckpt.load_variables(path),
                                img_size=64, batch_size=2)(images)
    det, valid = Predictor(pair["cfg"], state_dict=load_weights(path),
                           img_size=64, batch_size=2, device="cpu")(images)
    # tests/test_torch_predictor.py::test_predictor_matches_jax's tolerance
    np.testing.assert_array_equal(valid, jvalid)
    assert 0 < valid.sum() < valid.size
    np.testing.assert_allclose(det[..., :4], jdet[..., :4], rtol=1e-4,
                               atol=1e-3)
    np.testing.assert_allclose(det[..., 4:6], jdet[..., 4:6], atol=1e-5)
    np.testing.assert_array_equal(det[..., 6], jdet[..., 6])


@pytest.mark.parametrize("layout", ["variables", "params"])
def test_backbone_pretrained_from_ckpt(pair, tmp_path, layout):
    tree = {"params": pair["jvars"]["params"],
            "batch_stats": pair["jvars"]["batch_stats"]}
    state = _bundle(tree) if layout == "variables" else tree
    path = jax_ckpt.save_checkpoint(state, False, output_dir=str(tmp_path),
                                    filename="cls.ckpt")
    model = build_model(pair["cfg"], device="cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    load_pretrained_backbone(model, path)
    after = model.state_dict()
    for key, value in after.items():
        if key.startswith("backbone.") and \
                not key.endswith("num_batches_tracked"):
            assert torch.equal(value, pair["sd"][key]), key
        elif not key.startswith("backbone."):
            assert torch.equal(value, before[key]), key


def test_backbone_pretrained_graft_through_trainer_cfg(pair, tmp_path):
    """MODEL.BACKBONE_PRETRAINED names a .ckpt: the Trainer's model starts
    from its backbone."""
    from tests.fixtures import make_fake_coco
    from yolov4_tpu_torch.config import Config
    from yolov4_tpu_torch.engine.trainer import Trainer
    path = jax_ckpt.save_checkpoint(_bundle(pair["jvars"]), False,
                                    output_dir=str(tmp_path),
                                    filename="pre.ckpt")
    root = str(tmp_path / "coco")
    make_fake_coco(root, "train2017", n_images=4, seed=0)
    make_fake_coco(root, "val2017", n_images=2, seed=1)
    cfg = Config.from_dict({
        "MODEL": {"WIDTH": 0.25, "DEPTH": 0.25, "COMPUTE_DTYPE": "float32",
                  "BACKBONE_PRETRAINED": path},
        "TRAIN": {"IMGSIZE": 64, "OUTPUT_DIR": str(tmp_path / "out")},
        "TEST": {"IMGSIZE": 64, "BATCH_SIZE": 2},
        "DATA": {"WORKERS": 0, "BATCH_SIZE": 2}})
    trainer = Trainer(cfg, root, device="cpu")
    key = "backbone.stage3.base.conv.weight"
    assert torch.equal(trainer.model.state_dict()[key], pair["sd"][key])


def test_resume_from_ckpt_is_refused(pair, tmp_path):
    """A resume reads a .ckpt, and refuses one whose opt_state is not
    optax's state of the port's optimizer for this model (this bundle's is
    a stand-in without ``nu``): never a fresh optimizer where the file
    holds a state."""
    path = jax_ckpt.save_checkpoint(_bundle(pair["jvars"]), False,
                                    output_dir=str(tmp_path),
                                    filename="checkpoint.ckpt")
    raw = load_checkpoint_raw(path)
    assert is_jax_layout(raw) and raw["meta"]["epoch"] == 3
    model = build_model(pair["cfg"], device="cpu", train=True)
    with pytest.raises(ValueError, match=r"opt_state: the port's Adam needs "
                       r"optax's state with the keys \['count', 'mu', "
                       r"'nu'\], the file holds \['count', 'mu'\]"):
        bundle_from_jax(raw, build_optimizer(pair["cfg"], model), model,
                        path)


def _adam_state(params, seed=4):
    """optax's Adam state over ``params``, its moments drawn with numpy."""
    rng = np.random.default_rng(seed)
    draw = (lambda a: rng.normal(0, 1e-2, np.shape(a)).astype(np.float32))
    return optax.ScaleByAdamState(
        count=np.asarray(3, np.int32), mu=jax.tree.map(draw, params),
        nu=jax.tree.map(lambda a: np.square(draw(a)), params))


# what a resume of a .ckpt loads (utils/checkpoint, utils/convert): the
# tensor count and float64 sum of the model's state and the Adam state; run
# here and in a process where flax, msgpack and jax cannot load
RESUMED_DIGEST = """
from yolov4_tpu_torch.config import Config
from yolov4_tpu_torch.models import build_model
from yolov4_tpu_torch.optim import build_optimizer
from yolov4_tpu_torch.utils.checkpoint import load_checkpoint_raw
from yolov4_tpu_torch.utils.convert import bundle_from_jax


def resumed_digest(path, raw_cfg):
    cfg = Config.from_dict(raw_cfg)
    model = build_model(cfg, device="cpu", train=True)
    opt = build_optimizer(cfg, model)
    bundle = bundle_from_jax(load_checkpoint_raw(path), opt, model, path)
    model.load_state_dict(bundle["variables"])
    opt.load_state_dict(bundle["opt_state"])
    tensors = list(model.state_dict().values()) + [
        t for s in opt.state_dict()["state"].values() for t in s.values()]
    return len(tensors), float(sum(t.double().sum() for t in tensors))
"""


def test_reader_needs_neither_flax_nor_msgpack(pair, tmp_path):
    """Weights and a resume's whole state (variables, optax's Adam state,
    meta) read in a process where flax, msgpack and jax cannot load."""
    bundle = dict(_bundle(pair["jvars"]),
                  opt_state=_adam_state(pair["jvars"]["params"]))
    path = jax_ckpt.save_checkpoint(bundle, False, output_dir=str(tmp_path),
                                    filename="m.ckpt")
    probe = (
        "import sys\n"
        "for name in ('flax', 'msgpack', 'jax'):\n"
        "    sys.modules[name] = None\n"
        "from yolov4_tpu_torch.utils.convert import load_weights\n"
        f"sd = load_weights({str(path)!r})\n"
        "print(len(sd), float(sum(v.double().sum() for v in sd.values())))\n"
        + RESUMED_DIGEST +
        f"print(*resumed_digest({str(path)!r}, {SMALL_CFG!r}))\n")
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, timeout=300, check=True).stdout.split()
    want = load_weights(path)
    assert int(out[0]) == len(want)
    assert float(out[1]) == float(sum(v.double().sum()
                                      for v in want.values()))
    here = {}
    exec(RESUMED_DIGEST, here)
    n, total = here["resumed_digest"](str(path), SMALL_CFG)
    assert (int(out[2]), float(out[3])) == (n, total)
