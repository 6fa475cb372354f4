"""The port's train-time data path (data/transforms.py, data/coco.py,
data/pipeline.py) against the JAX package's: bit-equal for the same seeds.
"""

import numpy as np
import pytest
import torch

from tests.fixtures import make_fake_coco
from yolov4_tpu.config import Config as JaxConfig
from yolov4_tpu.data.coco import COCODataset as JaxCOCODataset
from yolov4_tpu.data.pipeline import DataLoader as JaxDataLoader
from yolov4_tpu.data.transforms import Transform as JaxTransform
from yolov4_tpu_torch.config import Config
from yolov4_tpu_torch.data.coco import COCODataset
from yolov4_tpu_torch.data.pipeline import DataLoader, build_data
from yolov4_tpu_torch.data.transforms import Transform

torch.set_num_threads(1)


def _cfgs(mosaic):
    raw = {"AUGMENTATION": {"IS_MOSAIC": mosaic}}
    return JaxConfig.from_dict(raw), Config.from_dict(raw)


def _images(seed, n):
    rng = np.random.default_rng(seed)
    imgs, boxes = [], []
    for _ in range(n):
        h, w = int(rng.integers(60, 140)), int(rng.integers(60, 140))
        imgs.append(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
        k = int(rng.integers(0, 5))
        xy = rng.uniform(0, [w * 0.6, h * 0.6], (k, 2))
        wh = rng.uniform(4, [w * 0.4, h * 0.4], (k, 2))
        cls = rng.integers(0, 80, (k, 1))
        boxes.append(np.concatenate([xy, wh, cls], 1).astype(np.float64))
    return imgs, boxes


def _assert_same_item(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    assert got[0].dtype == want[0].dtype
    assert set(got[1]) == set(want[1])
    for key in want[1]:
        np.testing.assert_array_equal(np.asarray(got[1][key]),
                                      np.asarray(want[1][key]))


@pytest.mark.parametrize("mosaic", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 7])
def test_train_transform_bit_equal_to_jax(mosaic, seed):
    jcfg, cfg = _cfgs(mosaic)
    imgs, boxes = _images(seed, 4 if mosaic else 1)
    want = JaxTransform(jcfg, is_train=True, seed=seed)(
        [i.copy() for i in imgs], [b.copy() for b in boxes], 64)
    got = Transform(cfg, is_train=True, seed=seed)(
        [i.copy() for i in imgs], [b.copy() for b in boxes], 64)
    _assert_same_item(got, want)
    assert got[0].shape == (64, 64, 3) and got[0].dtype == np.float32


@pytest.fixture(scope="module")
def coco_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("coco"))
    make_fake_coco(root, "train2017", n_images=10, seed=0)
    make_fake_coco(root, "val2017", n_images=3, seed=1)
    return root


def _datasets(root, mosaic=True, size=64):
    jcfg, cfg = _cfgs(mosaic)
    want = JaxCOCODataset(root, "train2017", img_size=size, is_train=True,
                          transform=JaxTransform(jcfg, is_train=True))
    got = COCODataset(root, img_size=size,
                      transform=Transform(cfg, is_train=True),
                      name="train2017", is_train=True)
    return got, want


@pytest.mark.parametrize("mosaic", [False, True])
def test_train_dataset_bit_equal_to_jax(coco_root, mosaic):
    got, want = _datasets(coco_root, mosaic)
    assert len(got) == len(want) == 10
    for i, seed in ((0, 3), (4, 11), (9, 12345)):
        got.seed(seed)
        want.seed(seed)
        _assert_same_item(got[i], want[i])
    got.set_img_size(96)
    want.set_img_size(96)
    assert got.get_img_size() == 96
    got.seed(5)
    want.seed(5)
    _assert_same_item(got[2], want[2])


def _loader_pair(root, workers=0, **kw):
    got_ds, want_ds = _datasets(root)
    want = JaxDataLoader(want_ds, batch_size=3, shuffle=True, num_workers=0,
                         seed=4, drop_last=True, **kw)
    got = DataLoader(got_ds, batch_size=3, shuffle=True, num_workers=workers,
                     seed=4, drop_last=True, **kw)
    return got, want


def _assert_same_batches(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for (gi, gt), (wi, wt) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        assert set(gt) == set(wt)
        for key in wt:
            np.testing.assert_array_equal(gt[key], wt[key])
    return got


def test_loader_order_and_seeds_equal_to_jax_per_epoch(coco_root):
    got, want = _loader_pair(coco_root)
    assert len(got) == len(want) == 3           # 10 // 3, last dropped
    firsts = []
    for epoch in (0, 1):
        got.set_epoch(epoch)
        want.set_epoch(epoch)
        batches = _assert_same_batches(got, want)
        firsts.append(batches[0][1]["img_info"][:, -1])
    assert not np.array_equal(*firsts)          # reshuffled per epoch


def test_loader_start_batch_and_size_schedule_equal_to_jax(coco_root):
    got, want = _loader_pair(coco_root)
    for loader in (got, want):
        loader.set_epoch(2)
        loader.start_batch = 1
        loader.size_schedule = lambda epoch, i: (64, 96)[i % 2]
    batches = _assert_same_batches(got, want)
    assert [b[0].shape[1] for b in batches] == [96, 64]
    assert got.start_batch == 0                 # one-shot


def test_loader_two_workers_equal_to_no_workers(coco_root):
    """Seeds come from (seed, epoch, batch, slot), never from a worker."""
    plain, _ = _loader_pair(coco_root, workers=0)
    pooled, _ = _loader_pair(coco_root, workers=2)
    try:
        for loader in (plain, pooled):
            loader.set_epoch(1)
            loader.size_schedule = lambda epoch, i: (64, 96)[i % 2]
        _assert_same_batches(pooled, plain)
    finally:
        pooled.close()


def test_build_data_train_and_val_loaders(coco_root):
    cfg = Config.from_dict({"TRAIN": {"IMGSIZE": 64},
                            "TEST": {"IMGSIZE": 96, "BATCH_SIZE": 2},
                            "DATA": {"BATCH_SIZE": 4, "WORKERS": 0}})
    train, val = build_data(cfg, coco_root, seed=1)
    assert len(train) == 2 and train.drop_last and train.shuffle
    imgs, target = next(iter(train))
    assert imgs.shape == (4, 64, 64, 3) and imgs.dtype == np.float32
    assert target["padded_labels"].shape == (4, 60, 5)
    assert len(val) == 2 and not val.shuffle
    imgs, target = next(iter(val))
    assert imgs.shape == (2, 96, 96, 3) and imgs.dtype == np.uint8
