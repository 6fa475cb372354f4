"""The port's device augmentation (data/device_aug.py) against the JAX
package's on the CPU, at S = 64 and B <= 4: HSV both ways; the resample
weights against JAX's ``compute_weight_mat``; each step and the whole
deterministic half with the same parameters fed to both; the parameter
draws by distribution; ``CanvasTransform`` bit-equal; and the Trainer with
AUGMENTATION.DEVICE (uint8 canvases in, augmentation inside the step, a
resume that repeats the augmented stream).

Tolerances: images within 1e-3 on the 0-255 pixel scale, boxes within
1e-4 px, valid label rows and their order exact. Both sides run the same
float32 operations; the resample's products sum in another order.
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.image.scale import _fill_triangle_kernel, compute_weight_mat

from tests.fixtures import make_fake_coco
from yolov4_tpu.data import device_aug as J
from yolov4_tpu_torch.config import Config
from yolov4_tpu_torch.data import device_aug as T
from yolov4_tpu_torch.engine.trainer import Trainer
from yolov4_tpu_torch.parallel.train_step import aug_generator

torch.set_num_threads(1)

S, K = 64, 12
CFG_VALS = (0.3, 0.1, 1.5, 1.5, 0.2, True, True)  # the defaults
KW = dict(zip(("jitter", "hue", "saturation", "exposure", "min_offset",
               "flip", "dither"), CFG_VALS))
PIX_TOL = 1e-3   # on the 0-255 scale
BOX_TOL = 1e-4   # px


def _canvases(seed, b, k=K):
    """Member canvases [B, 4, S, S, 3] uint8 and boxes [B, 4, K, 5] (1 to
    K - 1 per member, some reaching the canvas edge)."""
    rng = np.random.default_rng(seed)
    canvases = rng.integers(0, 256, (b, 4, S, S, 3), dtype=np.uint8)
    boxes = np.zeros((b, 4, k, 5), np.float32)
    for i in range(b):
        for m in range(4):
            n = int(rng.integers(1, k))
            xy = rng.uniform(0, S - 8, (n, 2))
            boxes[i, m, :n, :2] = xy
            boxes[i, m, :n, 2:4] = np.minimum(xy + rng.uniform(2, 40, (n, 2)),
                                              S)
            boxes[i, m, :n, 4] = rng.integers(0, 80, n)
    return canvases, boxes


def _jax_params(seed, b):
    """(per-sample JAX parameter dicts, the same batched as torch)."""
    keys = jax.random.split(jax.random.PRNGKey(seed), b)
    per = [jax.device_get(J._sample_params(k, S, CFG_VALS)) for k in keys]
    batched = {name: torch.from_numpy(np.stack([np.asarray(p[name])
                                                for p in per]))
               for name in per[0]}
    for name in ("crop", "cut_x", "cut_y"):
        batched[name] = batched[name].long()
    return per, batched


def _close_boxes(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(got.sum(-1) > 0, want.sum(-1) > 0)
    np.testing.assert_array_equal(got[..., 4], want[..., 4])
    np.testing.assert_allclose(got, want, atol=BOX_TOL, rtol=0)


# --------------------------------------------------------------------- HSV

def test_hsv_both_ways_match_jax():
    rng = np.random.default_rng(0)
    rgb = rng.uniform(0, 255, (4, 16, 16, 3)).astype(np.float32)
    rgb[0, :4] = rgb[0, :4, :, :1]           # grey: delta 0
    rgb[0, 4] = 0.0                          # black: max 0
    rgb[1, :2, :, 0] = rgb[1, :2, :, 1]      # ties between channels
    want = np.asarray(J.rgb_to_hsv(jnp.asarray(rgb)))
    got = T.rgb_to_hsv(torch.from_numpy(rgb)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-6)
    hsv = np.stack([rng.uniform(-400, 800, (4, 16, 16)),   # any hue
                    rng.uniform(0, 1.5, (4, 16, 16)),
                    rng.uniform(0, 300, (4, 16, 16))], -1).astype(np.float32)
    hsv[2, :, :, 0] = 360.0 * rng.integers(-2, 3, (16, 16))  # sector ends
    want = np.asarray(J.hsv_to_rgb(jnp.asarray(hsv)))
    got = T.hsv_to_rgb(torch.from_numpy(hsv)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-6)


# ---------------------------------------------------------- resample weights

@pytest.mark.parametrize("scale,translation", [
    (1.0, 0.0),                 # identity
    (64 / 80, 8.0),             # zoom out: samples fall off the canvas
    (64 / 90, -3.5),            # zoom out, shifted
    (64 / 40, -20.0),           # zoom in
    (64 / 45, 30.0),            # zoom in with a paste-window shift
    (0.5, 40.0),                # most samples off the canvas
])
def test_resample_weights_match_compute_weight_mat(scale, translation):
    want = np.asarray(compute_weight_mat(
        S, S, jnp.float32(scale), jnp.float32(translation),
        _fill_triangle_kernel, False))
    got = T.resample_weights(S, S, torch.tensor([scale], dtype=torch.float32),
                             torch.tensor([translation],
                                          dtype=torch.float32))[0]
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    assert (want == 0).all(axis=0).any() == (scale < 1 or translation > 0)


# ------------------------------------------------ the deterministic half

def test_crop_matches_jax():
    canvases, boxes = _canvases(1, 2)
    per, p = _jax_params(1, 2)
    imgs = canvases.reshape(8, S, S, 3).astype(np.float32)
    rng = np.random.default_rng(1)
    ty = rng.integers(-12, 13, 8).astype(np.float32)
    tx = rng.integers(-12, 13, 8).astype(np.float32)
    crop = p["crop"].reshape(8, 4)
    got_img, got_box = T._crop(torch.from_numpy(imgs),
                               torch.from_numpy(boxes.reshape(8, K, 5)), crop,
                               S, (torch.from_numpy(ty), torch.from_numpy(tx)))
    for n in range(8):
        want_img, want_box = J._crop_one(
            jnp.asarray(imgs[n]), jnp.asarray(boxes.reshape(8, K, 5)[n]),
            jnp.asarray(crop[n].numpy(), jnp.int32), S,
            shift=(jnp.float32(ty[n]), jnp.float32(tx[n])))
        np.testing.assert_allclose(got_img[n].numpy(), np.asarray(want_img),
                                   atol=PIX_TOL, rtol=0)
        _close_boxes(got_box[n], want_box)


def test_mosaic_shifts_match_jax():
    per, p = _jax_params(2, 4)
    tx, ty = T._mosaic_shifts(p["crop"], p["flip"], p["cut_x"], p["cut_y"], S)
    for i, q in enumerate(per):
        want_tx, want_ty = J._mosaic_shifts(q["crop"], q["flip"], q["cut_x"],
                                            q["cut_y"], S)
        np.testing.assert_array_equal(tx[i].numpy(), np.asarray(want_tx))
        np.testing.assert_array_equal(ty[i].numpy(), np.asarray(want_ty))
    assert (tx != 0).any() and (ty != 0).any()


def test_flip_and_dither_match_jax():
    canvases, boxes = _canvases(3, 2)
    _, p = _jax_params(3, 2)
    imgs = canvases.reshape(8, S, S, 3).astype(np.float32)
    bx = boxes.reshape(8, K, 5)
    flips = torch.tensor([True, False] * 4)
    got_img, got_box = T._flip(torch.from_numpy(imgs), torch.from_numpy(bx),
                               flips, S)
    enabled = torch.tensor([True] * 7 + [False])
    dhue, dsat, dexp = (p[n].reshape(8) for n in ("dhue", "dsat", "dexp"))
    got_dither = T._dither(torch.from_numpy(imgs), dhue, dsat, dexp, enabled)
    for n in range(8):
        want_img, want_box = J._flip_one(jnp.asarray(imgs[n]),
                                         jnp.asarray(bx[n]),
                                         jnp.asarray(bool(flips[n])), S)
        np.testing.assert_array_equal(got_img[n].numpy(), np.asarray(want_img))
        np.testing.assert_array_equal(got_box[n].numpy(), np.asarray(want_box))
        want = J._dither_one(jnp.asarray(imgs[n]), jnp.float32(dhue[n]),
                             jnp.float32(dsat[n]), jnp.float32(dexp[n]),
                             jnp.asarray(bool(enabled[n])))
        np.testing.assert_allclose(got_dither[n].numpy(), np.asarray(want),
                                   atol=PIX_TOL, rtol=0)


def test_mosaic_matches_jax():
    canvases, boxes = _canvases(4, 3, k=20)
    per, p = _jax_params(4, 3)
    imgs = canvases.astype(np.float32)
    got_img, got_box = T._mosaic(torch.from_numpy(imgs),
                                 torch.from_numpy(boxes), p["cut_x"],
                                 p["cut_y"], S, 20)
    for i, q in enumerate(per):
        want_img, want_box = J._mosaic(jnp.asarray(imgs[i]),
                                       jnp.asarray(boxes[i]), q["cut_x"],
                                       q["cut_y"], S, 20)
        np.testing.assert_array_equal(got_img[i].numpy(), np.asarray(want_img))
        np.testing.assert_array_equal(got_box[i].numpy(), np.asarray(want_box))
    # the compaction dropped rows and kept the valid ones in order
    assert (got_box.sum(-1) > 0).sum() < (boxes.sum(-1) > 0).sum()


@pytest.mark.parametrize("seed", [0, 5])
def test_apply_params_matches_jax_augment_sample(seed, monkeypatch):
    """The whole deterministic half against the JAX package's own
    ``_augment_sample``, its parameter draw replaced by the same
    parameters."""
    canvases, boxes = _canvases(seed, 3)
    per, p = _jax_params(seed, 3)
    got_img, got_lab = T.apply_params(torch.from_numpy(canvases),
                                      torch.from_numpy(boxes), p, K)
    assert got_img.dtype == torch.float32 and got_img.shape == (3, S, S, 3)
    for i, q in enumerate(per):
        monkeypatch.setattr(J, "_sample_params", lambda *_, q=q: q)
        want_img, want_lab = J._augment_sample(
            None, jnp.asarray(canvases[i]), jnp.asarray(boxes[i]), S, K,
            CFG_VALS)
        np.testing.assert_allclose(got_img[i].numpy() * 255.0,
                                   np.asarray(want_img) * 255.0,
                                   atol=PIX_TOL, rtol=0)
        _close_boxes(got_lab[i], want_lab)
    assert int((got_lab.sum(-1) > 0).sum()) > 0
    assert bool(p["flip"].any()) and bool((p["crop"] < 0).any())


# ------------------------------------------------------------ the draws

def _ks_stat(a, b):
    a, b = np.sort(np.asarray(a, float)), np.sort(np.asarray(b, float))
    grid = np.concatenate([a, b])
    ca = np.searchsorted(a, grid, side="right") / len(a)
    cb = np.searchsorted(b, grid, side="right") / len(b)
    return float(np.max(np.abs(ca - cb)))


def _ks_crit(n, m, alpha=0.001):
    return float(np.sqrt(-np.log(alpha / 2.0) / 2.0)
                 * np.sqrt((n + m) / (n * m)))


def test_sample_params_distribution_matches_jax():
    n = 256  # samples: 4096 crop offsets, 1024 of each member draw
    keys = jax.random.split(jax.random.PRNGKey(0), n)
    want = jax.device_get(jax.vmap(
        lambda k: J._sample_params(k, S, CFG_VALS))(keys))
    got = {k: v.numpy() for k, v in T.sample_params(
        torch.Generator().manual_seed(0), n, S, **KW).items()}
    assert {k: v.shape for k, v in got.items()} == \
        {k: np.asarray(v).shape for k, v in want.items()}
    j = round(S * 0.3)
    lo, hi = int(S * 0.2), int(S * 0.8)
    # exact supports, both ends reached
    for name, support in (("crop", (-j, j)), ("cut_x", (lo, hi)),
                          ("cut_y", (lo, hi))):
        for draws in (got[name], np.asarray(want[name])):
            assert (draws.min(), draws.max()) == support, name
    assert np.abs(got["dhue"]).max() <= 0.1
    for name in ("dsat", "dexp"):
        assert got[name].min() >= 1 / 1.5 and got[name].max() <= 1.5
        assert 0.4 < (got[name] >= 1.0).mean() < 0.6
    assert got["dither"].all() and got["flip"].dtype == bool
    for name in ("crop", "cut_x", "dhue", "dsat", "dexp"):
        a, b = got[name].ravel(), np.asarray(want[name]).ravel()
        assert _ks_stat(a, b) < _ks_crit(len(a), len(b)), name
    # the flip fires on normal > 0.5: P = 0.3085; 1024 draws each
    for rate in (got["flip"].mean(), np.asarray(want["flip"]).mean()):
        assert abs(rate - 0.3085) < 4 * np.sqrt(0.3085 * 0.6915 / (4 * n))
    off = T.sample_params(torch.Generator().manual_seed(0), 64, S,
                          **dict(KW, flip=False, dither=False))
    assert not off["flip"].any() and not off["dither"].any()


def test_generator_depends_on_seed_and_step_only():
    def draw(seed, step):
        return T.sample_params(aug_generator(torch.device("cpu"), seed, step),
                               2, S, **KW)["crop"]
    assert torch.equal(draw(3, 7), draw(3, 7))
    assert not torch.equal(draw(3, 7), draw(3, 8))
    assert not torch.equal(draw(3, 7), draw(4, 7))


def test_augment_batch_shapes_and_ranges():
    canvases, boxes = _canvases(6, 4)
    imgs, labels = T.augment_batch(torch.Generator().manual_seed(1),
                                   torch.from_numpy(canvases),
                                   torch.from_numpy(boxes), S, K, **KW)
    assert imgs.shape == (4, S, S, 3) and labels.shape == (4, K, 5)
    assert 0.0 <= float(imgs.min()) and float(imgs.max()) <= 1.0
    valid = labels.sum(-1) > 0
    assert valid.any()
    assert (labels[valid][:, :4] >= 0).all() and (labels[valid][:, :2]
                                                  <= S).all()
    with pytest.raises(ValueError, match="canvases"):
        T.augment_batch(torch.Generator(), torch.from_numpy(canvases),
                        torch.from_numpy(boxes), 32, K)


# ----------------------------------------------------------- host side

def test_canvas_transform_bit_equal_to_jax():
    cfg = Config.from_dict({"DATA": {"MAX_NUM_LABELS": 5}})
    rng = np.random.default_rng(7)
    imgs, tlwh = [], []
    for h, w, n in ((48, 80, 3), (100, 60, 7), (64, 64, 0), (33, 91, 1)):
        imgs.append(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
        rows = np.zeros((n, 5))
        rows[:, :2] = rng.uniform(0, 30, (n, 2))
        rows[:, 2:4] = rng.uniform(2, 30, (n, 2))
        rows[:, 4] = rng.integers(0, 80, n)
        tlwh.append(rows)
    got_c, got_t = T.CanvasTransform(cfg)(imgs, tlwh, 64)
    want_c, want_t = J.CanvasTransform(cfg)(imgs, tlwh, 64)
    assert got_c.dtype == np.uint8 and got_c.shape == (4, 64, 64, 3)
    np.testing.assert_array_equal(got_c, want_c)
    assert got_t.keys() == want_t.keys()
    np.testing.assert_array_equal(got_t["member_boxes"],
                                  want_t["member_boxes"])
    assert T.CanvasTransform.is_mosaic


# ------------------------------------------------------------- Trainer

SMALL = {
    "MODEL": {"WIDTH": 0.25, "DEPTH": 0.25, "COMPUTE_DTYPE": "float32"},
    "AUGMENTATION": {"DEVICE": True},
    "TRAIN": {"IMGSIZE": 64, "MAX_EPOCHS": 2},
    "TEST": {"IMGSIZE": 64, "BATCH_SIZE": 2, "PRE_NMS_TOPK": 64,
             "MAX_DETS": 10},
    "DATA": {"WORKERS": 0, "BATCH_SIZE": 4},
}


def _cfg(out_dir):
    raw = {k: dict(v) for k, v in SMALL.items()}
    raw["TRAIN"]["OUTPUT_DIR"] = str(out_dir)
    return Config.from_dict(raw)


def _recording(trainer, seen, losses):
    step = trainer.train_step

    def recording(state, images, labels):
        seen.append((tuple(images.shape), images.dtype, tuple(labels.shape)))
        state = step(state, images, labels)
        losses.append(float(state.loss))
        return state

    trainer.train_step = recording


def test_trainer_with_device_aug_trains_and_resumes_the_stream(tmp_path):
    root = str(tmp_path / "coco")
    make_fake_coco(root, "train2017", n_images=8, seed=0)   # 2 steps/epoch
    make_fake_coco(root, "val2017", n_images=2, seed=1)
    out = tmp_path / "run"
    trainer = Trainer(_cfg(out), root, device="cpu", print_freq=1, seed=4)
    assert trainer.device_aug == T.device_aug_config(trainer.cfg)
    seen, losses = [], []
    _recording(trainer, seen, losses)
    save = trainer.save

    def saving(epoch, ap50, ap):
        save(epoch, ap50, ap)
        if epoch == 0:
            shutil.copyfile(out / "checkpoint.pth", tmp_path / "epoch1.pth")

    trainer.save = saving
    trainer.fit()
    # uint8 canvases and member boxes go up; the step augments them
    assert seen == [((4, 4, 64, 64, 3), torch.uint8, (4, 4, 60, 5))] * 4
    assert len(losses) == 4 and np.isfinite(losses).all()
    with open(out / "metrics.jsonl") as f:
        kinds = [json.loads(line)["kind"] for line in f]
    assert kinds.count("eval") == 2 and kinds.count("train") == 4

    resumed = Trainer(_cfg(tmp_path / "resumed"), root,
                      resume=str(tmp_path / "epoch1.pth"), device="cpu",
                      seed=4)
    assert (resumed.start_epoch, resumed.state.step) == (1, 2)
    again = []
    _recording(resumed, [], again)
    resumed.fit()
    # the resumed epoch sees the same augmented batches: same losses
    assert again == losses[2:]
    assert os.path.isfile(tmp_path / "resumed" / "checkpoint.pth")


def test_trainer_with_device_aug_follows_multiscale(tmp_path):
    """Canvases come at the loader's size and the step reads S from them."""
    root = str(tmp_path / "coco")
    make_fake_coco(root, "train2017", n_images=8, seed=2)
    make_fake_coco(root, "val2017", n_images=2, seed=3)
    cfg = _cfg(tmp_path / "ms")
    cfg["TRAIN"].update(MAX_EPOCHS=1, MULTISCALE=[32, 64], MULTISCALE_EVERY=1)
    # seed 2 draws 32 for the first batch and 64 for the second
    trainer = Trainer(cfg, root, device="cpu", seed=2)
    seen, losses = [], []
    _recording(trainer, seen, losses)
    trainer.fit()
    sizes = [shape[2] for shape, _, _ in seen]
    assert sizes == [trainer._ms_size_for(0, i) for i in range(2)]
    assert len(set(sizes)) == 2 and np.isfinite(losses).all()
