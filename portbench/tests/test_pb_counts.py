"""portbench/counts.py against values worked out by hand."""

import pytest
import torch

from portbench import counts
from portbench.reference.model import conv_shapes
from portbench.tests.pb_small import config as _config


def test_one_conv_from_shapes():
    # 3x3, 16 -> 32 channels, stride 1 on 8x8: 2 * (32*8*8) * (3*3*16)
    conv = torch.nn.Conv2d(16, 32, 3, 1, 1, device="meta")
    rows = conv_shapes(torch.nn.Sequential(conv), (2, 16, 8, 8))
    assert rows == [(2 * 32 * 8 * 8, 9 * 16)]
    assert sum(2 * o * p for o, p in rows) == 2 * 2 * 32 * 64 * 144


def test_k2_stage1_at_608_b64():
    # stage 1's body: 64 channels at 304x304, the six convs' weights
    # 64*64 * 3 (part1, part2_1_1, part2_2) + 64*32 + 32*64*9 + 128*64
    weights = 3 * 4096 + 2048 + 18432 + 8192
    assert weights == 40960
    ops = 2 * 64 * 304 * 304 * weights
    assert counts.k2_ops(64, 304, 304, 64, 0) == ops
    by_ops = ops / 989e12
    by_bytes = (2 * 64 * 304 * 304 * 64 * 2 + weights * 2
                + (64 + 64 + 32 + 64 + 64 + 64) * 4) / 3.35e12
    assert by_ops > by_bytes
    assert counts.k2_bound(64, 304, 304, 64, 0) == pytest.approx(by_ops)
    assert counts.k2_bound(64, 304, 304, 64, 0) * 1e3 == pytest.approx(
        0.4899, abs=1e-4)


def test_k2_forward_bound_matches_the_smokes_b16_figures():
    # chip_smoke's bounds at 608/b16: 0.1225, 0.0888, 0.2725 ms
    ms = [counts.k2_bound(*s) * 1e3 for s in counts.csp_stage_shapes(16,
                                                                      608)]
    assert ms == pytest.approx([0.1225, 0.0888, 0.2725], abs=1e-4)
    assert counts.k2_forward_bound(64, 608) == pytest.approx(
        4 * counts.k2_forward_bound(16, 608), rel=1e-3)


def test_k1_at_64x2048():
    ops = 14 * 64 * 2048 * 2047 / 2 + 3 * 64 * 2048
    assert counts.nms_bound(64, 2048) == pytest.approx(ops / 67e12)
    assert counts.nms_bound(64, 2048) * 1e6 == pytest.approx(28.04,
                                                             abs=0.01)


def test_yolov4_608_forward_near_134_gflop():
    # PR 5's 3.226 TFLOP a 608/b8 train step is 3 x 8 x 134.4 GFLOP
    cf = _config("yolov4-608")
    assert counts.forward_conv_flops(cf, 1, 608) / 1e9 == \
        pytest.approx(134.42, abs=0.01)
    assert counts.forward_conv_flops(cf, 2, 608) == \
        pytest.approx(2 * counts.forward_conv_flops(cf, 1, 608))


def test_classifier_256_forward():
    assert counts.forward_conv_flops(_config("cspdarknet53-256"), 1, 256) \
        / 1e9 == pytest.approx(13.07, abs=0.01)
