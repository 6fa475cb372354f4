"""The whole slice on the CPU: the port's Predictor against the JAX
package's on the same weights and uint8 images, the detect CLI, the weight
files, and the CUDA-by-default rule of the entry points."""

import cv2
import numpy as np
import pytest
import torch
import yaml

from tests.test_torch_helpers import nchw, small_model_pair
from yolov4_tpu.engine.predictor import Predictor as JaxPredictor
from yolov4_tpu_torch import detect
from yolov4_tpu_torch.engine.predictor import Predictor
from yolov4_tpu_torch.models import build_model
from yolov4_tpu_torch.utils.convert import load_weights

torch.set_num_threads(1)

TOPK = 64
SLICE_TEST = {"PRE_NMS_TOPK": TOPK, "MAX_DETS": 50, "CONFTHRE": 0.05,
              "NMSTHRE": 0.45}


@pytest.fixture(scope="module")
def slice_pair():
    # seed 9 / head_scale 0.5: chosen so that the top pair and box scores
    # are separated far beyond the two frameworks' forward difference
    # (asserted in the test, not assumed)
    jcfg, cfg, jmodel, jvars, sd = small_model_pair(seed=9, head_scale=0.5)
    for c in (jcfg, cfg):
        c["TEST"].update(SLICE_TEST)
    images = np.random.default_rng(2).integers(0, 256, (2, 64, 64, 3),
                                               dtype=np.uint8)
    return dict(jcfg=jcfg, cfg=cfg, jmodel=jmodel, jvars=jvars, sd=sd,
                images=images)


def test_predictor_matches_jax(slice_pair):
    p = slice_pair
    x = p["images"].astype(np.float32) / 255.0
    want_preds = np.asarray(p["jmodel"].apply(p["jvars"], x, train=False))
    model = build_model(p["cfg"], device="cpu")
    model.load_state_dict(p["sd"])
    model.eval()
    with torch.no_grad():
        got_preds = model(nchw(x)).numpy()
    # The precondition that makes detections comparable at all: every
    # order the postprocess decides (top boxes, top pairs, greedy rank)
    # is decided by score gaps larger than the forward difference. With
    # these weights the smallest gap is ~2.4e-6 and the largest score
    # difference ~9e-8 (1.5 float32 ulps at 0.5).
    diff = np.abs(got_preds[..., 4:5] * got_preds[..., 5:]
                  - want_preds[..., 4:5] * want_preds[..., 5:]).max()
    gaps = []
    for b in range(2):
        pair = np.sort((want_preds[b, :, 4:5] * want_preds[b, :, 5:]).ravel())
        best = np.sort(want_preds[b, :, 4] * want_preds[b, :, 5:].max(-1))
        gaps += [np.diff(pair[-TOPK - 1:]).min(),
                 np.diff(best[-TOPK - 1:]).min()]
        assert pair[-TOPK] >= SLICE_TEST["CONFTHRE"]  # no -1.0 fill in top K
    assert min(gaps) > 20 * diff, (min(gaps), diff)

    jdet, jvalid = JaxPredictor(p["jcfg"], variables=p["jvars"], img_size=64,
                                batch_size=2)(p["images"])
    det, valid = Predictor(p["cfg"], state_dict=p["sd"], img_size=64,
                           batch_size=2, device="cpu")(p["images"])
    assert det.shape == (2, 50, 7) and valid.shape == (2, 50)
    assert np.isfinite(det).all()
    np.testing.assert_array_equal(valid, jvalid)
    assert 0 < valid.sum() < valid.size  # NMS dropped some, kept some
    # boxes: the decoded f32 forward's tolerance; scores: far below gaps
    np.testing.assert_allclose(det[..., :4], jdet[..., :4], rtol=1e-4,
                               atol=1e-3)
    np.testing.assert_allclose(det[..., 4:6], jdet[..., 4:6], atol=1e-5)
    np.testing.assert_array_equal(det[..., 6], jdet[..., 6])


def test_short_batch_is_padded(slice_pair):
    p = slice_pair
    pred = Predictor(p["cfg"], state_dict=p["sd"], img_size=64, batch_size=2,
                     device="cpu")
    det1, valid1 = pred(p["images"][:1])
    det2, valid2 = pred(p["images"])
    assert det1.shape == (1, 50, 7)
    np.testing.assert_array_equal(det1[0], det2[0])
    np.testing.assert_array_equal(valid1[0], valid2[0])
    with pytest.raises(ValueError):
        pred(np.zeros((3, 64, 64, 3), np.uint8))
    with pytest.raises(TypeError):
        pred(p["images"].astype(np.float32))


def test_entry_points_default_to_cuda_and_never_fall_back(slice_pair,
                                                         tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        Predictor(slice_pair["cfg"], img_size=64, batch_size=1)
    src = tmp_path / "src"
    src.mkdir()
    cv2.imwrite(str(src / "a.jpg"), np.zeros((40, 40, 3), np.uint8))
    with pytest.raises(RuntimeError, match="CUDA"):
        detect.main(["--source", str(src), "--dest", str(tmp_path / "out")])


def test_detect_cli_writes_drawn_images(slice_pair, tmp_path):
    cfg_file = tmp_path / "small.cfg"
    cfg_file.write_text(yaml.safe_dump({
        "MODEL": {"WIDTH": 0.25, "DEPTH": 0.25, "COMPUTE_DTYPE": "float32"},
        "TEST": {"IMGSIZE": 64, **SLICE_TEST}}))
    ckpt = tmp_path / "w.pth.tar"
    torch.save({"epoch": 3, "state_dict": {
        f"module.{k}": v for k, v in slice_pair["sd"].items()}}, ckpt)
    src = tmp_path / "src"
    src.mkdir()
    rng = np.random.default_rng(4)
    shapes = {"one.jpg": (90, 120), "two.JPG": (70, 50)}
    for name, (h, w) in shapes.items():
        cv2.imwrite(str(src / name),
                    rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
    dest = detect.main(["--cfg", str(cfg_file), "--ckpt", str(ckpt),
                        "--source", str(src), "--dest", str(tmp_path / "out"),
                        "--device", "cpu"])
    written = sorted(p.name for p in dest.iterdir())
    assert written == sorted(shapes)
    for name, (h, w) in shapes.items():
        img = cv2.imread(str(dest / name))
        assert img is not None and img.shape == (h, w, 3)


def test_weight_files_round_trip(slice_pair, tmp_path):
    sd = slice_pair["sd"]
    path = tmp_path / "w.npz"
    np.savez(path, **{f"module.{k}": v.numpy() for k, v in sd.items()})
    loaded = load_weights(str(path))
    assert set(loaded) == set(sd)
    for k in sd:
        assert torch.equal(loaded[k], sd[k]), k
    pt = tmp_path / "w.pt"
    torch.save(sd, pt)
    model = build_model(slice_pair["cfg"], device="cpu")
    model.load_state_dict(load_weights(str(pt)))


def test_reference_wrapper_with_numpy_metadata_loads(slice_pair, tmp_path):
    """The reference trainer saves COCOeval's numpy float64 APs beside the
    weights: val, detect and BACKBONE_PRETRAINED read such a wrapper with
    weights_only=True; any other global is refused by name."""
    import argparse

    from tests.fixtures import make_fake_coco
    from yolov4_tpu_torch import val
    from yolov4_tpu_torch.utils.checkpoint import load_pretrained_backbone
    sd = slice_pair["sd"]
    ckpt = tmp_path / "w.pth.tar"
    torch.save({"epoch": np.int64(3), "state_dict": {
        f"module.{k}": v for k, v in sd.items()},
        "ap50": np.float64(0.5), "ap": [np.float64(0.25), np.float32(0.125)],
        "dtype": np.dtype(np.float64)}, ckpt)
    cfg_file = tmp_path / "small.cfg"
    cfg_file.write_text(yaml.safe_dump({
        "MODEL": {"WIDTH": 0.25, "DEPTH": 0.25, "COMPUTE_DTYPE": "float32"},
        "TEST": {"IMGSIZE": 64, **SLICE_TEST}}))
    root = str(tmp_path / "coco")
    make_fake_coco(root, "val2017", n_images=2, seed=5)
    ap, ap50 = val.main([root, "-c", str(cfg_file), "--checkpoint",
                         str(ckpt), "--device", "cpu", "--batch-size", "2"])
    assert 0.0 <= ap <= ap50 <= 1.0
    dest = detect.main(["--cfg", str(cfg_file), "--ckpt", str(ckpt),
                        "--source", str(tmp_path / "coco" / "images" /
                                        "val2017"),
                        "--dest", str(tmp_path / "out"), "--device", "cpu"])
    assert len(list(dest.iterdir())) == 2
    model = build_model(slice_pair["cfg"], device="cpu")
    load_pretrained_backbone(model, str(ckpt))
    key = "backbone.stage2.base.conv.weight"
    assert torch.equal(model.state_dict()[key], sd[key])
    bad = tmp_path / "bad.pth.tar"
    torch.save({"state_dict": sd, "args": argparse.Namespace(lr=1)}, bad)
    with pytest.raises(ValueError, match=r"bad\.pth\.tar.*argparse\.Namespace"):
        load_weights(str(bad))
