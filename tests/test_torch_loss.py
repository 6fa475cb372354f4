"""The port's YOLOLoss (ops/loss.py) against the JAX package's: the
decode_loss golden, value and gradients on random outputs for "mse" and
the four IoU variants, and BCE's gradient at p = 0 and p = 1."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolov4_tpu.config import DEFAULTS
from yolov4_tpu.ops.boxes import iou_variant_elementwise as jax_iou_variant
from yolov4_tpu.ops.loss import YOLOLoss as JaxYOLOLoss
from yolov4_tpu.ops.loss import _bce_sum as jax_bce_sum
from yolov4_tpu_torch.ops.boxes import iou_variant_elementwise
from yolov4_tpu_torch.ops.loss import YOLOLoss, bce_sum

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "decode_loss.npz")
MODEL_CFG = DEFAULTS["MODEL"]
BOX_LOSSES = ["mse", "iou", "giou", "diou", "ciou"]


def test_loss_golden():
    golden = np.load(GOLDEN)
    outputs = [{"layer_no": i,
                "output": torch.from_numpy(golden[f"out{i}"]),
                "pred": torch.from_numpy(golden[f"pred{i}"])} for i in range(3)]
    loss = YOLOLoss(MODEL_CFG, ignore_thresh=0.7)(
        outputs, {"padded_labels": torch.from_numpy(golden["labels"])})
    np.testing.assert_allclose(float(loss), float(golden["loss"]), rtol=2e-4)


def _labels(b=2, img=64):
    """Labels whose assignments never share an (anchor, cell): the JAX
    package keeps an unspecified one of colliding box writes. Checked
    below against the port's own assignment rule."""
    labels = np.zeros((b, 60, 5), np.float32)
    labels[0, :4] = [[20, 30, 10, 12, 5], [44, 12, 16, 20, 63],
                     [33, 40, 50, 36, 1], [6, 58, 4, 6, 79]]
    labels[1, :3] = [[12, 50, 20, 8, 17], [40, 24, 30, 44, 0],
                     [55, 9, 60, 12, 2]]
    return labels


def _assignments(labels):
    anchors = np.asarray(MODEL_CFG["ANCHORS"], np.float32)
    cells = set()
    for b, k in zip(*np.nonzero(labels.sum(-1) > 0)):
        cx, cy, w, h, _ = labels[b, k]
        inter = np.minimum(w, anchors[:, 0]) * np.minimum(h, anchors[:, 1])
        best = int(np.argmax(inter / (w * h + anchors.prod(1) - inter)))
        stride = (8, 16, 32)[best // 3]
        cells.add((b, best, int(cy / stride), int(cx / stride)))
    return cells


def _random_outputs(seed=0, b=2, img=64):
    """Per-scale train outputs: xy/obj/cls probabilities, raw wh, and
    decoded boxes, a share of which sit on a ground truth so that the
    ignore mask (IoU > 0.7) is exercised."""
    rng = np.random.default_rng(seed)
    labels = _labels(b, img)
    outs = []
    for layer_no, stride in enumerate((8, 16, 32)):
        f = img // stride
        output = rng.uniform(0.02, 0.98, (b, 3, f, f, 85)).astype(np.float32)
        output[..., 2:4] = rng.normal(0, 1, (b, 3, f, f, 2))
        pred = np.concatenate([rng.uniform(0, f, (b, 3, f, f, 2)),
                               rng.uniform(0.2, f, (b, 3, f, f, 2))],
                              -1).astype(np.float32)
        for bi in range(b):
            for k in range(3):
                box = labels[bi, k, :4] / stride
                a = int(rng.integers(3))
                j, i = rng.integers(f, size=2)
                pred[bi, a, j, i] = box * rng.uniform(0.97, 1.03, 4)
        outs.append({"layer_no": layer_no, "output": output, "pred": pred})
    return outs, labels


@pytest.fixture(scope="module")
def jax_losses():
    outs, labels = _random_outputs()
    res = {}
    for kind in BOX_LOSSES:
        crit = JaxYOLOLoss(MODEL_CFG, ignore_thresh=0.7, box_loss=kind)

        def f(o, p):
            return crit([{"layer_no": i, "output": o[i], "pred": p[i]}
                         for i in range(3)],
                        {"padded_labels": jnp.asarray(labels)})

        o = [jnp.asarray(x["output"]) for x in outs]
        p = [jnp.asarray(x["pred"]) for x in outs]
        val, (go, gp) = jax.jit(jax.value_and_grad(f, argnums=(0, 1)))(o, p)
        res[kind] = (float(val), [np.asarray(g) for g in go],
                     [np.asarray(g) for g in gp])
    return outs, labels, res


def test_test_labels_have_no_scatter_collisions():
    labels = _labels()
    assert len(_assignments(labels)) == int((labels.sum(-1) > 0).sum())


@pytest.mark.parametrize("kind", BOX_LOSSES)
def test_loss_and_gradients_match_jax(jax_losses, kind):
    outs, labels, res = jax_losses
    want, want_go, want_gp = res[kind]
    o = [torch.from_numpy(x["output"]).requires_grad_(True) for x in outs]
    p = [torch.from_numpy(x["pred"]).requires_grad_(True) for x in outs]
    loss = YOLOLoss(MODEL_CFG, ignore_thresh=0.7, box_loss=kind)(
        [{"layer_no": i, "output": o[i], "pred": p[i]} for i in range(3)],
        {"padded_labels": torch.from_numpy(labels)})
    loss.backward()
    # float32 sums of ~10^4 terms in another order
    np.testing.assert_allclose(float(loss), want, rtol=1e-5)
    for got, w in zip(o + p, want_go + want_gp):
        # "mse" takes no gradient through the decoded boxes: None in torch
        g = got.grad if got.grad is not None else torch.zeros_like(got)
        # elementwise gradients: the same formula, rounding only
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-6)
    # the ignore mask and the IoU terms saw real overlaps
    assert any(float(t.grad[..., 4].abs().max()) > 0 for t in o)


@pytest.mark.parametrize("kind", ["iou", "giou", "diou", "ciou"])
def test_iou_variant_matches_jax_with_degenerate_boxes(kind):
    rng = np.random.default_rng(5)
    pred = rng.uniform(0.5, 4, (64, 4)).astype(np.float32)
    gt = rng.uniform(0.5, 4, (64, 4)).astype(np.float32)
    gt[:8] = 0.0                          # masked cells carry zero boxes
    want = np.asarray(jax_iou_variant(jnp.asarray(pred), jnp.asarray(gt),
                                      kind=kind))
    got = iou_variant_elementwise(torch.from_numpy(pred),
                                  torch.from_numpy(gt), kind=kind)
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_bce_gradient_finite_and_equal_to_jax_at_zero_and_one():
    p = np.array([0.0, 1.0, 0.0, 1.0, 0.3, 0.999], np.float32)
    t = np.array([0.0, 1.0, 1.0, 0.0, 0.5, 1.0], np.float32)
    want_val, want = jax.value_and_grad(
        lambda v: jax_bce_sum(v, jnp.asarray(t)))(jnp.asarray(p))
    pt = torch.from_numpy(p).requires_grad_(True)
    val = bce_sum(pt, torch.from_numpy(t))
    val.backward()
    assert np.isfinite(pt.grad.numpy()).all()
    np.testing.assert_allclose(float(val), float(want_val), rtol=1e-6)
    np.testing.assert_allclose(pt.grad.numpy(), np.asarray(want), rtol=1e-6)
    # masked cells (p = t = 0 or 1) contribute exactly nothing
    np.testing.assert_array_equal(pt.grad.numpy()[:2], 0.0)
    # torch's own BCELoss agrees where it is finite
    ref = torch.from_numpy(p[4:]).requires_grad_(True)
    torch.nn.BCELoss(reduction="sum")(ref, torch.from_numpy(t[4:])).backward()
    np.testing.assert_allclose(pt.grad.numpy()[4:], ref.grad.numpy(),
                               rtol=1e-6)
