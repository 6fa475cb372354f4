"""The port's postprocess against the reference golden and the JAX
package's postprocess on the CPU (where both take the plain NMS).

torch.topk and lax.top_k may order exactly tied scores differently, and
the -1.0 fill of below-threshold pairs makes ties; ``span`` then depends on
which invalid rows were picked. So the random cases draw continuous
scores with at least K pairs above conf_thre (no tie, no fill in the
top K), and the golden case is compared as a score-sorted set.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolov4_tpu.ops.postprocess import postprocess as jax_postprocess
from yolov4_tpu_torch.ops.nms_cuda import greedy_nms_mask_cuda
from yolov4_tpu_torch.ops.postprocess import _rank_in_class, postprocess

torch.set_num_threads(1)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")


def _canon(arr):
    order = np.lexsort((arr[:, 0], arr[:, 6], -arr[:, 4] * arr[:, 5]))
    return arr[order]


@pytest.mark.parametrize("image", [0, 1])
def test_postprocess_golden(image):
    golden = np.load(os.path.join(GOLDEN_DIR, "postprocess.npz"))
    det, valid = postprocess(torch.from_numpy(golden["preds"]), 80,
                             float(golden["conf"]), float(golden["nms"]),
                             pre_nms_topk=1024, max_dets=512)
    want = golden[f"det{image}"]
    got = det[image][valid[image]].numpy()
    assert got.shape[0] == want.shape[0]
    np.testing.assert_allclose(_canon(got), _canon(want), rtol=1e-4,
                               atol=1e-4)


def _random_predictions(seed, b=2, n=600, c=80):
    r = np.random.default_rng(seed)
    preds = np.zeros((b, n, 5 + c), np.float32)
    preds[..., 0:2] = r.uniform(-20, 620, (b, n, 2))  # unclipped centres
    preds[..., 2:4] = r.uniform(10, 160, (b, n, 2))
    preds[..., 4] = r.uniform(0.3, 1.0, (b, n))
    preds[..., 5:] = r.uniform(0.0, 1.0, (b, n, c))
    return preds


@pytest.mark.parametrize("seed,max_dets,cat_cap,count", [
    (0, 100, 100, False),   # max_dets <= cat_cap: the cap is a no-op
    (1, 300, 5, False),     # max_dets > cat_cap: rank gating
    (2, 100, 5, True),      # relevant count without gating
    (3, 300, 0, True),      # cap disabled
])
def test_matches_jax_k2048(seed, max_dets, cat_cap, count):
    preds = _random_predictions(seed)
    conf, nms_t, k = 0.05, 0.45, 2048
    assert (preds[..., 4:5] * preds[..., 5:] >= conf).sum(axis=(1, 2)).min() >= k
    kw = dict(pre_nms_topk=k, max_dets=max_dets, cat_cap=cat_cap,
              return_relevant_count=count)
    want = [np.asarray(a) for a in
            jax_postprocess(jnp.asarray(preds), 80, conf, nms_t, **kw)]
    got = [t.numpy() for t in
           postprocess(torch.from_numpy(preds), 80, conf, nms_t, **kw)]
    assert len(got) == len(want) == (3 if count else 2)
    assert got[0].shape == (2, max_dets, 7)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6, atol=1e-6)
    if count:
        np.testing.assert_array_equal(got[2], want[2])
    assert got[1].sum() > 0


def test_plain_engine_equals_auto_on_cpu():
    preds = torch.from_numpy(_random_predictions(4))
    a = postprocess(preds, 80, 0.05, 0.45)
    p = postprocess(preds, 80, 0.05, 0.45, nms_engine="plain")
    assert torch.equal(a[0], p[0]) and torch.equal(a[1], p[1])
    assert greedy_nms_mask_cuda.launches == 0
    with pytest.raises(ValueError):
        postprocess(preds, 80, 0.05, 0.45, nms_engine="pallas")


def test_approx_topk_is_an_exact_no_op():
    preds = torch.from_numpy(_random_predictions(5))
    exact = postprocess(preds, 80, 0.05, 0.45, pre_nms_topk=256, max_dets=64)
    with pytest.warns(UserWarning, match="APPROX_TOPK"):
        approx = postprocess(preds, 80, 0.05, 0.45, pre_nms_topk=256,
                             max_dets=64, topk_approx=True)
    assert torch.equal(exact[0], approx[0])


def test_rank_in_class_matches_jax():
    from yolov4_tpu.ops.postprocess import _rank_in_class as jax_rank
    r = np.random.default_rng(6)
    cls = r.integers(0, 5, (2, 64)).astype(np.int32)
    scores = np.round(r.random((2, 64)), 1).astype(np.float32)  # ties
    keep = r.random((2, 64)) < 0.7
    want = np.asarray(jax_rank(jnp.asarray(cls), jnp.asarray(scores),
                               jnp.asarray(keep), 5))
    got = _rank_in_class(torch.from_numpy(cls), torch.from_numpy(scores),
                         torch.from_numpy(keep), 5).numpy()
    np.testing.assert_array_equal(got, want)


def test_analytic_case():
    """Best box kept, same-class overlap dropped, other class kept."""
    def row(cx, cy, w, h, obj, cls_idx, cls_p):
        out = np.zeros(85, np.float32)
        out[:5] = [cx, cy, w, h, obj]
        out[5 + cls_idx] = cls_p
        return out
    preds = np.stack([row(100, 100, 50, 50, 0.9, 3, 0.9),
                      row(105, 105, 50, 50, 0.8, 3, 0.8),
                      row(300, 300, 50, 50, 0.7, 3, 0.9),
                      row(105, 105, 50, 50, 0.8, 7, 0.8),
                      row(100, 100, 50, 50, 0.1, 3, 0.1)])[None]
    det, valid = postprocess(torch.from_numpy(preds), 80, 0.3, 0.4,
                             pre_nms_topk=64, max_dets=10)
    kept = det[0][valid[0]].numpy()
    assert kept.shape[0] == 3
    np.testing.assert_allclose(kept[0, :4], [75, 75, 125, 125], rtol=1e-6)
    assert set(kept[:, 6].astype(int)) == {3, 7}
