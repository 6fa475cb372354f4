"""The port's native COCOeval matcher (yolov4_tpu_torch/native/fastops.c):
bit-equal to its numpy version and to the JAX package's C matcher on the
same inputs; the port's evaluator fuzzed against the naive line-faithful
pycocotools port (tests/naive_cocoeval.py) through each matcher; and the
val2017-scale host-time gate, its stats equal to the JAX evaluator's."""

import time

import numpy as np
import pytest
import torch

from naive_cocoeval import NaiveCOCOeval
from yolov4_tpu import native as jax_native
from yolov4_tpu.eval.cocoeval import COCOEvaluator as JaxCOCOEvaluator
from yolov4_tpu_torch import native
from yolov4_tpu_torch.data.synthetic import MemoryIndex, val2017_scale_case
from yolov4_tpu_torch.eval import cocoeval
from yolov4_tpu_torch.eval.cocoeval import COCOEvaluator

torch.set_num_threads(1)

MATCHERS = ("c", "numpy")


def _batch(rng, n_img):
    """One (category, area range) batch of ``n_img`` images: IoUs on a
    coarse grid (ties), crowd and ignored gts, images without detections
    and images without gts."""
    nd = rng.integers(0, 12, n_img)
    ng = rng.integers(0, 9, n_img)
    nd[rng.random(n_img) < 0.2] = 0
    ng[rng.random(n_img) < 0.2] = 0
    ious = np.round(rng.random(int((nd * ng).sum())), 2)
    g_ig = rng.integers(0, 2, int(ng.sum())).astype(np.uint8)
    crowd = (rng.random(int(ng.sum())) < 0.3).astype(np.uint8)
    d_out = rng.integers(0, 2, int(nd.sum())).astype(np.uint8)
    return (ious, g_ig, crowd, d_out, nd.astype(np.int64),
            ng.astype(np.int64))


def test_native_builds_here():
    assert native.available(), native._build_error


@pytest.mark.parametrize("block", range(4))
def test_c_matcher_bit_equal_to_numpy_and_to_jax(block):
    for seed in range(block * 50, (block + 1) * 50):
        rng = np.random.default_rng(30_000 + seed)
        args = _batch(rng, int(rng.integers(1, 9)))
        got = native.coco_match_batch(*args, cocoeval.IOU_THRS)
        plain = cocoeval._match_batch_plain(*args)
        jax_c = jax_native.coco_match_batch(*args, cocoeval.IOU_THRS)
        for a, b, c in zip(got, plain, jax_c):
            assert a.dtype == bool and a.shape == (10, int(args[4].sum()))
            np.testing.assert_array_equal(a, b, err_msg=f"seed {seed}")
            np.testing.assert_array_equal(a, c, err_msg=f"seed {seed}")


@pytest.fixture(params=MATCHERS)
def matcher(request, monkeypatch):
    """Each matcher in turn: numpy as on a host that cannot build the C
    one."""
    if request.param == "numpy":
        monkeypatch.setattr(native, "get_fastops", lambda: None)
    return request.param


def test_the_matcher_that_ran_is_reported(matcher):
    index = MemoryIndex([{"image_id": 1, "category_id": 1,
                          "bbox": [0, 0, 10, 10]}], [1], [1])
    ev = COCOEvaluator(index)
    assert ev.matcher is None
    ev.add_detection(1, 1, [1, 0, 10, 10], 0.9)
    stats = ev.evaluate(verbose=False)
    assert ev.matcher == matcher and stats[1] == pytest.approx(1.0)
    got = native.coco_match_batch(*_batch(np.random.default_rng(0), 2),
                                  cocoeval.IOU_THRS)
    assert (got is None) == (matcher == "numpy")


# --- the fuzz of tests/test_cocoeval_diff.py, through each matcher --------

_SIZES = [0.0, 4.0, 10.0, 30.0, 32.0, 33.0, 95.0, 96.0, 97.0, 200.0]
_AREAS = [100.0, 1024.0, 1025.0, 9216.0, 9217.0, 1e5]


def _random_case(rng):
    """tests/test_cocoeval_diff.py::_random_case, draw for draw."""
    n_img = int(rng.integers(1, 5))
    n_cat = int(rng.integers(1, 4))
    img_ids = list(range(1, n_img + 1))
    cat_ids = [int(c) for c in
               rng.choice([1, 2, 3, 7, 11], size=n_cat, replace=False)]
    gts, dts = [], []
    for img in img_ids:
        for cat in cat_ids:
            for _ in range(int(rng.integers(0, 5))):
                g = {"image_id": img, "category_id": cat,
                     "bbox": [float(rng.integers(0, 8) * 25),
                              float(rng.integers(0, 8) * 25),
                              float(rng.choice(_SIZES)),
                              float(rng.choice(_SIZES))]}
                if rng.random() < 0.2:
                    g["iscrowd"] = 1
                if rng.random() < 0.15:
                    g["ignore"] = 1
                if rng.random() < 0.2:
                    g["area"] = float(rng.choice(_AREAS))
                gts.append(g)
            for _ in range(int(rng.integers(0, 7))):
                if gts and rng.random() < 0.6:
                    src = gts[int(rng.integers(0, len(gts)))]["bbox"]
                    if rng.random() < 0.5:
                        bb = list(src)
                    else:
                        bb = [src[0] + float(rng.integers(-5, 6)),
                              src[1] + float(rng.integers(-5, 6)),
                              max(0.0, src[2] + float(rng.integers(-8, 9))),
                              max(0.0, src[3] + float(rng.integers(-8, 9)))]
                else:
                    bb = [float(rng.integers(0, 8) * 25),
                          float(rng.integers(0, 8) * 25),
                          float(rng.choice(_SIZES)),
                          float(rng.choice(_SIZES))]
                dts.append({"image_id": img, "category_id": cat, "bbox": bb,
                            "score": float(rng.integers(1, 10)) / 10.0})
    return gts, dts, img_ids, cat_ids


def _run_both(gts, dts, img_ids, cat_ids, matcher):
    fast = COCOEvaluator(MemoryIndex(gts, img_ids, cat_ids), img_ids=img_ids,
                         cat_ids=cat_ids)
    fast.add_detections(dts)
    fast_stats = fast.evaluate(verbose=False)
    assert fast.matcher == matcher
    return fast_stats, NaiveCOCOeval(gts, dts, img_ids, cat_ids).run()


@pytest.mark.parametrize("block", range(5))
def test_fuzz_200_cases_each(block, matcher):
    for seed in range(block * 200, (block + 1) * 200):
        rng = np.random.default_rng(seed)
        fast_stats, naive_stats = _run_both(*_random_case(rng), matcher)
        np.testing.assert_allclose(fast_stats, naive_stats, rtol=0,
                                   atol=1e-9,
                                   err_msg=f"stats diverged at seed {seed}")


def test_edge_cases(matcher):
    """tests/test_cocoeval_diff.py's four edge cases: no detections, no
    gts, all scores tied, more than 100 detections in one (img, cat)."""
    gts = [{"image_id": 1, "category_id": 1, "bbox": [0, 0, 50, 50]}]
    fast, naive = _run_both(gts, [], [1], [1], matcher)
    np.testing.assert_allclose(fast, naive, atol=1e-9)
    assert fast[0] == 0.0

    dts = [{"image_id": 1, "category_id": 1, "bbox": [0, 0, 50, 50],
            "score": 0.9}]
    fast, naive = _run_both([], dts, [1], [1], matcher)
    np.testing.assert_allclose(fast, naive, atol=1e-9)
    assert fast[0] == -1.0

    rng = np.random.default_rng(7)
    gts, dts = [], []
    for img in (1, 2, 3):
        for k in range(4):
            gts.append({"image_id": img, "category_id": 1,
                        "bbox": [k * 60.0, 0.0, 50.0, 50.0]})
            dts.append({"image_id": img, "category_id": 1,
                        "bbox": [k * 60.0 + float(rng.integers(0, 12)), 0.0,
                                 50.0, 50.0], "score": 0.5})
    fast, naive = _run_both(gts, dts, [1, 2, 3], [1], matcher)
    np.testing.assert_allclose(fast, naive, atol=1e-9)

    gts = [{"image_id": 1, "category_id": 1, "bbox": [0, 0, 50, 50]}]
    dts = [{"image_id": 1, "category_id": 1,
            "bbox": [200.0 + i, 200.0, 20.0, 20.0],
            "score": 1.0 - i * 0.005} for i in range(119)]
    dts.append({"image_id": 1, "category_id": 1, "bbox": [0, 0, 50, 50],
                "score": 0.01})
    fast, naive = _run_both(gts, dts, [1], [1], matcher)
    np.testing.assert_allclose(fast, naive, atol=1e-9)
    assert fast[0] == 0.0


def test_val2017_scale_under_60s_and_equal_to_jax():
    """tests/test_cocoeval_perf.py's gate on the port: 5000 images x 80
    categories x 100 detections in under 60 s of host time, through the C
    matcher, with the JAX evaluator's stats."""
    index, dts = val2017_scale_case(5000)
    ev = COCOEvaluator(index)
    t0 = time.time()
    ev.add_detections(dts)
    stats = ev.evaluate(verbose=False)
    elapsed = time.time() - t0
    assert ev.matcher == "c"
    assert stats.shape == (12,)
    assert 0.0 < stats[0] < 1.0
    assert 0.5 < stats[8] <= 1.0
    assert elapsed < 60.0, f"5k-image eval took {elapsed:.1f}s (budget 60s)"
    ref = JaxCOCOEvaluator(index)
    ref.add_detections(dts)
    np.testing.assert_allclose(stats, ref.evaluate(verbose=False), rtol=0,
                               atol=1e-12)
