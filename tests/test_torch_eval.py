"""The port's val path on the CPU: COCOeval, detections_to_coco, the eval
dataset and loader against the JAX package on the same inputs; validate()
with an oracle predictor (AP = 1); and ``python -m yolov4_tpu_torch.val``
end to end on a small fake COCO."""

import numpy as np
import pytest
import torch
import yaml

from tests.fixtures import make_fake_coco
from yolov4_tpu.config import load_config as jax_load_config
from yolov4_tpu.data.coco import COCODataset as JaxCOCODataset
from yolov4_tpu.data.coco import COCOIndex as JaxCOCOIndex
from yolov4_tpu.data.pipeline import DataLoader as JaxDataLoader
from yolov4_tpu.data.transforms import Transform as JaxTransform
from yolov4_tpu.engine.evaluator import \
    detections_to_coco as jax_detections_to_coco
from yolov4_tpu.eval.cocoeval import COCOEvaluator as JaxCOCOEvaluator
from yolov4_tpu_torch import val
from yolov4_tpu_torch.config import load_config
from yolov4_tpu_torch.data.coco import (COCO_CLASS_IDS, COCODataset,
                                        COCOIndex)
from yolov4_tpu_torch.data.pipeline import DataLoader
from yolov4_tpu_torch.data.transforms import Transform
from yolov4_tpu_torch.engine.evaluator import detections_to_coco, validate
from yolov4_tpu_torch.eval.cocoeval import COCOEvaluator

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def fake_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("coco_val"))
    make_fake_coco(root, "val2017", n_images=6, seed=3)
    return root


def _detection_rows(index, seed):
    """Jittered copies of the ground truths (some in the wrong class) plus
    false positives, with random scores: a ranking with TPs, FPs and
    misses at every IoU threshold."""
    rng = np.random.default_rng(seed)
    cats = sorted(index.get_cat_ids())
    rows = []
    for img_id in index.get_img_ids():
        for ann in index.load_anns(img_id):
            x, y, w, h = ann["bbox"]
            for _ in range(int(rng.integers(0, 3))):
                j = rng.normal(0, 0.08, 4) * [w, h, w, h]
                cat = (ann["category_id"] if rng.random() < 0.8
                       else int(rng.choice(cats)))
                rows.append({"image_id": img_id, "category_id": cat,
                             "bbox": [x + j[0], y + j[1], w + j[2], h + j[3]],
                             "score": float(rng.random())})
        for _ in range(int(rng.integers(0, 4))):
            rows.append({"image_id": img_id,
                         "category_id": int(rng.choice(cats)),
                         "bbox": list(rng.uniform(0, 60, 4) + [0, 0, 4, 4]),
                         "score": float(rng.random())})
    return rows


def test_cocoeval_matches_jax(fake_root):
    path = f"{fake_root}/annotations/instances_val2017.json"
    ours, theirs = COCOIndex(path), JaxCOCOIndex(path)
    rows = _detection_rows(ours, seed=7)
    stats = []
    for cls, index in ((COCOEvaluator, ours), (JaxCOCOEvaluator, theirs)):
        ev = cls(index)
        ev.add_detections(rows)
        stats.append(ev.evaluate(verbose=False))
    assert stats[0].shape == (12,)
    assert 0.0 < stats[0][1] < 1.0          # AP50: neither vacuous nor perfect
    np.testing.assert_allclose(stats[0], stats[1], atol=1e-12, rtol=0)


@pytest.mark.parametrize("img_info", [
    [480.0, 640.0, 320.0, 320.0, 0.0, 0.0, 42, 3],        # stretch
    [480.0, 640.0, 240.0, 320.0, 0.0, 40.0, 43, 4],       # letterbox
    [375.0, 500.0, 416.0, 416.0, 42, 0],                  # 4 + 2 layout
])
def test_detections_to_coco_matches_jax(img_info):
    rng = np.random.default_rng(1)
    xy = rng.uniform(0, 300, (20, 2))
    det = np.concatenate([xy, xy + rng.uniform(5, 100, (20, 2)),
                          rng.random((20, 2)),
                          rng.integers(0, 80, (20, 1))], 1).astype(np.float32)
    valid = rng.random(20) < 0.7
    info = np.asarray(img_info)
    got = detections_to_coco(det, valid, info, COCO_CLASS_IDS)
    want = jax_detections_to_coco(det, valid, info, COCO_CLASS_IDS)
    assert len(got) == int(valid.sum()) and got == want


@pytest.mark.parametrize("letterbox", [False, True])
def test_eval_batches_match_jax(fake_root, letterbox):
    cfg, jcfg = load_config(), jax_load_config()
    cfg["TEST"]["LETTERBOX"] = jcfg["TEST"]["LETTERBOX"] = letterbox
    ours = DataLoader(COCODataset(fake_root, img_size=96,
                                  transform=Transform(cfg, keep_uint8=True)),
                      batch_size=4)
    theirs = JaxDataLoader(
        JaxCOCODataset(fake_root, "val2017", img_size=96, is_train=False,
                       transform=JaxTransform(jcfg, is_train=False,
                                              keep_uint8=True)),
        batch_size=4, shuffle=False, num_workers=0)
    assert len(ours) == len(theirs) == 2
    for (img, tgt), (jimg, jtgt) in zip(ours, theirs):
        assert img.dtype == np.uint8 and img.shape == (4, 96, 96, 3)
        np.testing.assert_array_equal(img, jimg)
        assert set(tgt) == set(jtgt)
        for key in tgt:
            np.testing.assert_array_equal(tgt[key], jtgt[key])


class OraclePredictor:
    """Emits the ground-truth labels (already in model-input pixels) as
    perfect detections (pattern of tests/test_evaluator.py)."""

    def __init__(self, max_dets=100):
        self.max_dets = max_dets
        self.conf_thre = 0.5
        self.nms_thre = 0.5
        self.labels = None

    def dispatch(self, imgs):
        b = imgs.shape[0]
        det = torch.zeros((b, self.max_dets, 7))
        valid = torch.zeros((b, self.max_dets), dtype=torch.bool)
        for i in range(b):
            labels = self.labels[i]
            n = int((labels.sum(1) > 0).sum())
            cx, cy, w, h, cls = torch.from_numpy(labels[:n]).T
            det[i, :n] = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2,
                                      cy + h / 2, torch.ones(n),
                                      torch.ones(n), cls], 1)
            valid[i, :n] = True
        return det, valid

    @staticmethod
    def fetch_local(out):
        return tuple(t.numpy() for t in out)


class LoaderWithHook:
    def __init__(self, loader, predictor):
        self.loader, self.predictor = loader, predictor
        self.dataset = loader.dataset

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        for imgs, target in self.loader:
            self.predictor.labels = target["padded_labels"]
            yield imgs, target


def test_validate_oracle_gets_ap1(fake_root):
    cfg = load_config()
    dataset = COCODataset(fake_root, img_size=128,
                          transform=Transform(cfg, keep_uint8=True))
    predictor = OraclePredictor()
    ap, ap50 = validate(LoaderWithHook(DataLoader(dataset, batch_size=4),
                                       predictor),
                        predictor, conf_threshold=0.001, verbose=False)
    assert ap50 == pytest.approx(1.0, abs=1e-6)
    assert ap == pytest.approx(1.0, abs=0.02)  # resize rounding at high IoU
    # thresholds are call-scoped
    assert (predictor.conf_thre, predictor.nms_thre) == (0.5, 0.5)


def test_val_main_on_cpu(tmp_path):
    root = str(tmp_path / "coco")
    make_fake_coco(root, "val2017", n_images=4, seed=5)
    cfg_path = tmp_path / "small.cfg"
    cfg_path.write_text(yaml.safe_dump({
        "MODEL": {"WIDTH": 0.25, "DEPTH": 0.25, "COMPUTE_DTYPE": "float32",
                  "PALLAS_CSP": True},
        "TEST": {"IMGSIZE": 64}}))
    ap, ap50 = val.main([root, "-c", str(cfg_path), "--device", "cpu",
                         "--batch-size", "3", "--conf-thre", "0.001"])
    assert np.isfinite(ap) and np.isfinite(ap50)
    assert 0.0 <= ap <= ap50 <= 1.0
    # a JAX package .ckpt of the same weights scores the same
    from yolov4_tpu.utils.checkpoint import save_checkpoint
    from yolov4_tpu.utils.torch_convert import convert_state_dict
    from yolov4_tpu_torch.config import Config
    from yolov4_tpu_torch.models import build_model
    model = build_model(Config.from_dict(yaml.safe_load(cfg_path.read_text())),
                        device="cpu")
    save_checkpoint({"variables": convert_state_dict(model.state_dict())},
                    False, output_dir=str(tmp_path), filename="model.ckpt")
    assert val.main([root, "-c", str(cfg_path), "--device", "cpu",
                     "--batch-size", "3", "--conf-thre", "0.001",
                     "--checkpoint", str(tmp_path / "model.ckpt")]) \
        == (ap, ap50)


def test_val_takes_every_flag_of_the_root_val(tmp_path):
    """Every option of the root val.py's parser parses in the port's."""
    import ast
    from pathlib import Path
    tree = ast.parse((Path(__file__).parents[1] / "val.py").read_text())
    flags = [arg.value for node in ast.walk(tree)
             if isinstance(node, ast.Call)
             and getattr(node.func, "attr", "") == "add_argument"
             for arg in node.args if isinstance(arg, ast.Constant)
             and arg.value.startswith("-")]
    assert {"--workers", "--approx-topk", "--quant"} <= set(flags)
    values = {"--cfg": "x.cfg", "-c": "x.cfg", "--checkpoint": "w.pth",
              "-ckpt": "w.pth", "--quant": "int8"}
    argv = ["DIR"]
    for flag in flags:
        if flag in ("--approx-topk", "--letterbox"):
            argv.append(flag)
        else:
            argv += [flag, values.get(flag, "2")]
    args = val.parse_args(argv)
    assert args.workers == 2 and args.approx_topk


@pytest.mark.parametrize("argv,workers", [([], 3), (["--workers", "0"], 0),
                                          (["--workers", "2"], 2)])
def test_val_workers_reach_the_eval_loader(tmp_path, monkeypatch, argv,
                                           workers):
    """--workers overrides DATA.WORKERS for the eval loader, as the root
    val.py does."""
    root = str(tmp_path / "coco")
    make_fake_coco(root, "val2017", n_images=2, seed=5)
    cfg_path = tmp_path / "small.cfg"
    cfg_path.write_text(yaml.safe_dump({
        "MODEL": {"WIDTH": 0.25, "DEPTH": 0.25, "COMPUTE_DTYPE": "float32"},
        "TEST": {"IMGSIZE": 64}, "DATA": {"WORKERS": 3}}))
    seen = {}

    def fake_validate(loader, predictor):
        seen["workers"] = loader.num_workers
        return 0.25, 0.5

    monkeypatch.setattr(val, "validate", fake_validate)
    assert val.main([root, "-c", str(cfg_path), "--device", "cpu"]
                    + argv) == (0.25, 0.5)
    assert seen["workers"] == workers


def test_val_approx_topk_sets_the_key_and_warns(tmp_path, monkeypatch):
    """--approx-topk sets TEST.APPROX_TOPK; the port warns that it ignores
    the TPU option and scores exactly as without it."""
    root = str(tmp_path / "coco")
    make_fake_coco(root, "val2017", n_images=3, seed=5)
    cfg_path = tmp_path / "small.cfg"
    cfg_path.write_text(yaml.safe_dump({
        "MODEL": {"WIDTH": 0.25, "DEPTH": 0.25, "COMPUTE_DTYPE": "float32"},
        "TEST": {"IMGSIZE": 64}, "DATA": {"WORKERS": 0}}))
    argv = [root, "-c", str(cfg_path), "--device", "cpu", "--batch-size",
            "3", "--conf-thre", "0.001"]
    keys = []
    real_predictor = val.Predictor

    def recording_predictor(cfg, **kwargs):
        keys.append(cfg["TEST"]["APPROX_TOPK"])
        return real_predictor(cfg, **kwargs)

    monkeypatch.setattr(val, "Predictor", recording_predictor)
    exact = val.main(argv)
    with pytest.warns(UserWarning, match="APPROX_TOPK"):
        approx = val.main(argv + ["--approx-topk"])
    assert keys == [False, True]
    assert approx == exact
