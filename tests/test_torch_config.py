"""The port's own copies of the JAX package's host code — config, eval
transform, box helpers, class names — against the originals."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolov4_tpu import config as jax_config
from yolov4_tpu.data.transforms import Transform as JaxTransform
from yolov4_tpu.ops import boxes as jax_boxes
from yolov4_tpu.utils import visualize as jax_visualize
from yolov4_tpu_torch import config
from yolov4_tpu_torch.data.transforms import Transform
from yolov4_tpu_torch.ops import boxes
from yolov4_tpu_torch.utils import visualize

torch.set_num_threads(1)

CONFIG_DIR = os.path.join(os.path.dirname(__file__), "..", "configs")


def test_defaults_equal_the_jax_package():
    assert config.DEFAULTS == jax_config.DEFAULTS


@pytest.mark.parametrize("name", sorted(os.listdir(CONFIG_DIR)))
def test_repo_configs_load_like_the_jax_package(name):
    path = os.path.join(CONFIG_DIR, name)
    assert config.load_config(path) == jax_config.load_config(path)


def test_tpu_only_keys_are_accepted_and_validated():
    cfg = config.Config.from_dict({
        "MODEL": {"S2D_STEM": True, "WPACK": "stage12", "SPLIT_HEAD": True,
                  "PALLAS_CSP": True, "QUANT": "int8_static",
                  "QUANT_STEM": True},
        "TEST": {"S2D_WIRE": False, "APPROX_TOPK": True}})
    assert cfg["MODEL"]["PALLAS_CSP"] is True
    for bad in ({"MODEL": {"QUANT": "int4"}}, {"TEST": {"IMGSIZE": 600}},
                {"MODEL": {"COMPUTE_DTYPE": "float16"}},
                {"MODEL": {"ANCHOR_MASK": [[0, 1], [2, 3], [4, 5]]}}):
        with pytest.raises(ValueError):
            config.Config.from_dict(bad)


@pytest.mark.parametrize("quant", ["int8", "int8_static"])
def test_quant_loads_and_refuses_to_build(quant):
    """MODEL.QUANT loads (the JAX package's configs carry it) and builds
    the int8 model: its sites marked with the mode (stages 3-5, neck and
    the head's hidden convs under QUANT_SPAN late), none under
    train=True; the Predictor carries the mode. An unknown mode is still
    refused."""
    from yolov4_tpu_torch.engine.predictor import Predictor
    from yolov4_tpu_torch.models import build_model
    from yolov4_tpu_torch.models.layers import quant_sites
    cfg = config.Config.from_dict({"MODEL": {"QUANT": quant, "WIDTH": 0.25,
                                             "DEPTH": 0.25,
                                             "QUANT_SPAN": "late"}})
    model = build_model(cfg, device="cpu")
    sites = quant_sites(model)
    assert sites and all(s.startswith(("backbone.stage3", "backbone.stage4",
                                       "backbone.stage5", "neck.", "head."))
                         for s in sites)
    assert {m.quant for m in model.modules()
            if getattr(m, "quant_site", "")} == {quant}
    assert not quant_sites(build_model(cfg, device="cpu", train=True))
    assert Predictor(cfg, device="cpu").quant == quant
    cfg["MODEL"]["QUANT"] = "int4"
    with pytest.raises(ValueError, match="quant"):
        build_model(cfg, device="cpu")


@pytest.mark.parametrize("letterbox", [False, True])
def test_val_transform_matches_jax(letterbox):
    cfg = config.Config.from_dict({"TEST": {"LETTERBOX": letterbox}})
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (75, 130, 3), dtype=np.uint8)
    labels = np.array([[10, 12, 40, 30, 3], [60, 5, 50, 60, 7]], np.float64)
    for keep_uint8 in (False, True):
        got_img, got = Transform(cfg, keep_uint8=keep_uint8)(
            [img], [labels], 64)
        want_img, want = JaxTransform(cfg, is_train=False,
                                      keep_uint8=keep_uint8)(
            [img], [labels], 64)
        assert got_img.dtype == want_img.dtype
        np.testing.assert_array_equal(got_img, want_img)
        np.testing.assert_array_equal(got["padded_labels"],
                                      want["padded_labels"])
        assert got["img_info"] == want["img_info"]


def test_box_helpers_match_jax():
    rng = np.random.default_rng(1)
    cxcywh = np.concatenate([rng.uniform(-50, 650, (3, 40, 2)),
                             rng.uniform(0, 200, (3, 40, 2))],
                            -1).astype(np.float32)
    np.testing.assert_array_equal(
        boxes.cxcywh_to_xyxy(torch.from_numpy(cxcywh)).numpy(),
        np.asarray(jax_boxes.cxcywh_to_xyxy(jnp.asarray(cxcywh))))
    xyxy = np.array(jax_boxes.cxcywh_to_xyxy(jnp.asarray(cxcywh)))
    a, b = xyxy[:, :30], xyxy[:, 10:]
    got = boxes.iou_pairwise_safe(torch.from_numpy(a),
                                  torch.from_numpy(b)).numpy()
    want = np.asarray(jax_boxes.iou_pairwise_safe(jnp.asarray(a),
                                                  jnp.asarray(b)))
    np.testing.assert_array_equal(got, want)
    xyxy = xyxy[0]
    for off in ((0.0, 0.0), (4.0, 9.0)):
        np.testing.assert_array_equal(
            boxes.unmap_to_source_xyxy(xyxy, (480, 640), (608, 608), off),
            jax_boxes.unmap_to_source_xyxy(xyxy, (480, 640), (608, 608), off))


def test_class_names_and_drawing_match_jax():
    for i in (-1, 0, 11, 79, 80):
        assert visualize.class_name(i) == jax_visualize.class_name(i)
    img = np.zeros((60, 80, 3), np.uint8)
    box = np.array([[5.0, 6.0, 50.0, 40.0]])
    got = visualize.draw_detections(img.copy(), box, [0.9], [2])
    want = jax_visualize.draw_detections(img.copy(), box, [0.9], [2])
    np.testing.assert_array_equal(got, want)
    assert got.any()
