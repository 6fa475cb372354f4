"""The port's plain greedy NMS: bit-equal keep masks against the JAX
package's greedy_nms_mask on every case of tests/test_nms_pallas.py, and
against the independent host greedy oracle. The CUDA wrapper, given CPU
tensors, takes the plain version and launches nothing."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolov4_tpu import native
from yolov4_tpu.ops.nms import greedy_nms_mask as jax_greedy_nms_mask
from yolov4_tpu_torch.ops.nms import greedy_nms_mask
from yolov4_tpu_torch.ops.nms_cuda import greedy_nms_mask_cuda

torch.set_num_threads(1)


def _case(seed, b, k, valid_p=0.85, spread=300.0, wh_hi=150.0):
    """tests/test_nms_pallas.py::_case, draw for draw."""
    r = np.random.default_rng(seed)
    c = r.uniform(0, spread, (b, k, 2)).astype(np.float32)
    wh = r.uniform(15, wh_hi, (b, k, 2)).astype(np.float32)
    boxes = np.concatenate([c, c + wh], -1)
    valid = r.random((b, k)) < valid_p
    return boxes, valid


def _both(boxes, valid, t, **kw):
    got = greedy_nms_mask(torch.from_numpy(boxes), torch.from_numpy(valid),
                          t, **kw).numpy()
    want = np.asarray(jax_greedy_nms_mask(jnp.asarray(boxes),
                                          jnp.asarray(valid), t))
    return got, want


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_matches_jax_k1024(seed):
    boxes, valid = _case(seed, 2, 1024)
    got, want = _both(boxes, valid, 0.45)
    assert got.dtype == np.bool_
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < valid.sum()  # suppression happened


@pytest.mark.parametrize("block", [128, 256, 512, 2048])
def test_block_size_does_not_change_the_mask(block):
    boxes, valid = _case(7, 2, 1024)
    got, want = _both(boxes, valid, 0.45, block=block)
    np.testing.assert_array_equal(got, want)


def test_dense_chains_match_jax_and_host_oracle():
    boxes, valid = _case(11, 3, 512, valid_p=0.95, spread=150.0, wh_hi=200.0)
    got, want = _both(boxes, valid, 0.4, block=128)
    np.testing.assert_array_equal(got, want)
    for i in range(boxes.shape[0]):
        oracle = native.greedy_nms_host(boxes[i], valid[i], 0.4)
        np.testing.assert_array_equal(got[i], oracle, err_msg=f"batch {i}")


def test_batch_isolation():
    boxes, valid = _case(5, 4, 256)
    got, want = _both(boxes, valid, 0.5, block=128)
    np.testing.assert_array_equal(got, want)
    for i in range(4):
        solo = greedy_nms_mask(torch.from_numpy(boxes[i:i + 1]),
                               torch.from_numpy(valid[i:i + 1]), 0.5,
                               block=128).numpy()
        np.testing.assert_array_equal(got[i], solo[0], err_msg=f"batch {i}")


def test_all_invalid_and_degenerate():
    boxes = np.zeros((1, 256, 4), np.float32)  # zero-area boxes
    valid = np.zeros((1, 256), bool)
    got, want = _both(boxes, valid, 0.4, block=128)
    assert not got.any()
    np.testing.assert_array_equal(got, want)
    valid[:, :10] = True
    got, want = _both(boxes, valid, 0.4, block=128)
    np.testing.assert_array_equal(got, want)


def test_class_offset_coordinates_match_jax():
    """The main path's input: coordinates lifted by class * span to ~1e5,
    where rounding decides IoU near the threshold."""
    r = np.random.default_rng(3)
    boxes, valid = _case(3, 2, 2048, spread=600.0, wh_hi=300.0)
    cls = r.integers(0, 80, (2, 2048, 1)).astype(np.float32)
    span = np.float32(2.0 * np.abs(boxes).max() + 1.0)
    boxes = boxes + cls * span
    got, want = _both(boxes, valid, 0.4)
    np.testing.assert_array_equal(got, want)


def test_cuda_wrapper_takes_the_plain_version_on_cpu():
    boxes, valid = _case(0, 2, 300)  # ragged K: the kernel masks it itself
    before = greedy_nms_mask_cuda.launches
    got = greedy_nms_mask_cuda(torch.from_numpy(boxes),
                               torch.from_numpy(valid), 0.45)
    assert greedy_nms_mask_cuda.launches == before == 0
    want = greedy_nms_mask(torch.from_numpy(boxes), torch.from_numpy(valid),
                           0.45)
    assert torch.equal(got, want)


def test_cuda_wrapper_rejects_other_devices():
    boxes = torch.zeros((1, 8, 4), device="meta")
    valid = torch.zeros((1, 8), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError):
        greedy_nms_mask_cuda(boxes, valid, 0.4)
