"""The port's plain greedy NMS: bit-equal keep masks against the JAX
package's greedy_nms_mask on every case of tests/test_nms_pallas.py, and
against the independent host greedy oracle. The CUDA wrapper, given CPU
tensors, takes the plain version and launches nothing.

The Hopper kernel's algorithm on the CPU: ops/nms.pair_mask_words (its
pair mask) composed with scan_mask_words (its block scan) gives the same
keep mask as the plain version and as the JAX Pallas kernel in interpret
mode, on every case above and on ragged K, a suppression chain across bit
63, and t = 0 and t = 1. The build key of ops/cuda_build covers the
headers a kernel source includes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolov4_tpu import native
from yolov4_tpu.ops.nms import greedy_nms_mask as jax_greedy_nms_mask
from yolov4_tpu.ops.nms_pallas import greedy_nms_mask_pallas
from yolov4_tpu_torch.ops import cuda_build, nms_cuda
from yolov4_tpu_torch.ops.boxes import iou_pairwise_safe
from yolov4_tpu_torch.ops.nms import (greedy_nms_mask, pair_mask_words,
                                      scan_mask_words)
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


@pytest.mark.parametrize("call", ["pair_mask", "scan"])
def test_launch_helpers_refuse_cpu_tensors(call):
    """The kernel's launches alone (for timing on the card) have no plain
    fallback: a CPU tensor is refused before anything is built."""
    boxes, valid = _case(0, 1, 64)
    bx, vd = torch.from_numpy(boxes), torch.from_numpy(valid)
    with pytest.raises(ValueError):
        if call == "pair_mask":
            nms_cuda.pair_mask_words_cuda(bx, 0.45)
        else:
            nms_cuda.scan_mask_words_cuda(
                torch.zeros((1, 64, 1), dtype=torch.int64), vd)


def test_cuda_wrapper_rejects_other_devices():
    boxes = torch.zeros((1, 8, 4), device="meta")
    valid = torch.zeros((1, 8), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError):
        greedy_nms_mask_cuda(boxes, valid, 0.4)


def _class_offset(seed, b, k):
    """Class-offset coordinates as on the main path (~1e5)."""
    boxes, valid = _case(seed, b, k, spread=600.0, wh_hi=300.0)
    cls = np.random.default_rng(seed).integers(0, 80, (b, k, 1))
    span = np.float32(2.0 * np.abs(boxes).max() + 1.0)
    return (boxes + cls * span).astype(np.float32), valid


def _chain(k, first):
    """Boxes 20 wide every 10 along x: each overlaps its neighbours at IoU
    1/3 and no other box, so at t = 0.3 greedy keeps every other valid box
    from ``first`` on, across each word boundary (bit 63 -> bit 0)."""
    x = np.arange(k, dtype=np.float32)[:, None] * 10.0
    boxes = np.concatenate([x, np.zeros_like(x), x + 20.0,
                            np.full_like(x, 20.0)], -1)[None]
    valid = np.arange(k)[None] >= first
    return boxes, valid


def _duplicates(seed, b, k):
    """Every box drawn twice in a row: at t = 1 only exact copies suppress."""
    boxes, valid = _case(seed, b, k // 2)
    return np.repeat(boxes, 2, axis=1), np.repeat(valid, 2, axis=1)


SCAN_CASES = {
    "k1024_seed0": lambda: (*_case(0, 2, 1024), 0.45),
    "k1024_seed1": lambda: (*_case(1, 2, 1024), 0.45),
    "k1024_seed2": lambda: (*_case(2, 2, 1024), 0.45),
    "block_size_case": lambda: (*_case(7, 2, 1024), 0.45),
    "dense_chains": lambda: (*_case(11, 3, 512, 0.95, 150.0, 200.0), 0.4),
    "batch_isolation_case": lambda: (*_case(5, 4, 256), 0.5),
    "all_invalid": lambda: (np.zeros((1, 256, 4), np.float32),
                            np.zeros((1, 256), bool), 0.4),
    "degenerate_ten_valid": lambda: (np.zeros((1, 256, 4), np.float32),
                                     np.arange(256)[None] < 10, 0.4),
    "class_offset_k2048": lambda: (*_class_offset(3, 2, 2048), 0.4),
    "ragged_k300": lambda: (*_case(0, 2, 300), 0.45),
    "ragged_k1000": lambda: (*_case(8, 2, 1000), 0.45),
    "chain_bit63_dropped": lambda: (*_chain(256, 0), 0.3),
    "chain_bit63_kept": lambda: (*_chain(256, 1), 0.3),
    "t0": lambda: (*_case(1, 2, 256), 0.0),
    "t1_duplicates": lambda: (*_duplicates(4, 2, 512), 1.0),
}


def _pallas(boxes, valid, t):
    """The JAX Pallas kernel in interpret mode, as tests/test_nms_pallas.py
    runs it. It takes K in whole blocks of 128: a ragged K is padded with
    invalid candidates after the last, which suppress nothing and are never
    kept, so the first K decisions stand."""
    b, k, _ = boxes.shape
    kp = -(-k // 128) * 128
    boxes = np.pad(boxes, ((0, 0), (0, kp - k), (0, 0)))
    valid = np.pad(valid, ((0, 0), (0, kp - k)))
    out = greedy_nms_mask_pallas(jnp.asarray(boxes), jnp.asarray(valid), t,
                                 block=128 if kp % 256 else 256,
                                 interpret=True)
    return np.asarray(out)[:, :k]


@pytest.mark.parametrize("name", sorted(SCAN_CASES))
def test_kernel_algorithm_matches_plain_and_pallas(name):
    boxes, valid, t = SCAN_CASES[name]()
    bx, vd = torch.from_numpy(boxes), torch.from_numpy(valid)
    got = scan_mask_words(pair_mask_words(bx, t), vd).numpy()
    np.testing.assert_array_equal(got, greedy_nms_mask(bx, vd, t).numpy())
    np.testing.assert_array_equal(got, _pallas(boxes, valid, t))
    if name.startswith("chain"):
        first = int(np.argmax(valid[0]))
        want = (np.arange(boxes.shape[1]) >= first) & (
            (np.arange(boxes.shape[1]) - first) % 2 == 0)
        np.testing.assert_array_equal(got[0], want)
        assert got[0, 63] == (first == 1) and got[0, 64] == (first == 0)


@pytest.mark.parametrize("t", [0.0, 0.45])
def test_pair_mask_words_layout(t):
    """Bit u of word w of row j is IoU(j, 64w + u) >= t for j < 64w + u <
    K, and 0 elsewhere (below the diagonal and past a ragged K)."""
    boxes, _ = _case(6, 2, 300)
    bx = torch.from_numpy(boxes)
    words = pair_mask_words(bx, t)
    assert words.shape == (2, 300, 5) and words.dtype == torch.int64
    bits = ((words[..., None] >> torch.arange(64)) & 1).bool()
    bits = bits.reshape(2, 300, 320)
    idx = torch.arange(300)
    upper = idx[:, None] < idx[None, :]
    want = (iou_pairwise_safe(bx, bx) >= t) & upper
    assert torch.equal(bits[..., :300], want)
    assert not bits[..., 300:].any()
    if t == 0.0:  # disjoint pairs suppress at t = 0: the guard must let them
        assert bool(bits[..., :300][:, upper].all())


def _write(path, text):
    path.write_text(text)
    return path


def test_build_key_covers_included_headers(tmp_path):
    src = _write(tmp_path / "k.cu", '#include <cstdint>\n#include "a.cuh"\n')
    _write(tmp_path / "a.cuh", '#pragma once\n  #  include "b.cuh"\n')
    header = _write(tmp_path / "b.cuh", "// v1\n")
    _write(tmp_path / "other.cuh", "// not included\n")
    flags = ("-O3",)
    key = cuda_build.build_key(src, flags)
    assert cuda_build.build_key(src, flags) == key
    _write(tmp_path / "other.cuh", "// edited\n")
    assert cuda_build.build_key(src, flags) == key
    _write(header, "// v2\n")
    edited = cuda_build.build_key(src, flags)
    assert edited != key
    assert cuda_build.build_key(src, ("-O2",)) != edited


def test_kernel_sources_share_the_ptx_header():
    """nms.cu and csp.cu include csrc/ptx.cuh, so it is in their keys."""
    for name in ("nms.cu", "csp.cu"):
        text = (cuda_build.CSRC_DIR / name).read_bytes()
        assert cuda_build._LOCAL_INCLUDE.findall(text) == [b"ptx.cuh"], name
    assert "-fmad=false" in nms_cuda.NVCC_FLAGS
    assert "--use_fast_math" not in nms_cuda.NVCC_FLAGS
    assert "-v" in nms_cuda.NVCC_FLAGS


def test_ptxas_report_parses_a_build_log():
    log = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z15nms_mask_kernelPK6float4Pyiiif' for 'sm_90a'
ptxas info    : Function properties for _Z15nms_mask_kernelPK6float4Pyiiif
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 38 registers, used 1 barriers, 5120 bytes smem, 392 bytes cmem[0]
ptxas info    : Compiling entry function '_Z5otherv' for 'sm_90a'
ptxas info    : Used 8 registers, 352 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_115nms_scan_kernelILb1EEEvPKyPKhPhiii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_115nms_scan_kernelILb1EEEvPKyPKhPhiii
    16 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers, 8 bytes smem, 400 bytes cmem[0]
"""
    rows = cuda_build.ptxas_report(log, "nms_")
    assert [r["registers"] for r in rows] == [38, 40]
    assert rows[0] == dict(name="_Z15nms_mask_kernelPK6float4Pyiiif",
                           registers=38, static_smem=5120, stack=0,
                           spill_stores=0, spill_loads=0)
    assert (rows[1]["stack"], rows[1]["spill_stores"],
            rows[1]["spill_loads"], rows[1]["static_smem"]) == (16, 8, 4, 8)


def test_ring_depth_tool_inputs():
    """tools/nms_ring_depth.py times the scan where every candidate
    survives and where most are suppressed (checked on a slice)."""
    from yolov4_tpu_torch.tools import nms_ring_depth
    data = nms_ring_depth.inputs()
    for boxes, valid in data.values():
        assert boxes.dtype == np.float32 and boxes.shape == (16, 2048, 4)
        assert valid.shape == (16, 2048)
    boxes, valid = data["all_kept"]
    assert valid.all()
    bx = torch.from_numpy(np.ascontiguousarray(boxes[:2, :512]))
    vd = torch.ones((2, 512), dtype=torch.bool)
    assert greedy_nms_mask(bx, vd, 0.4).all()
    boxes, valid = data["suppression_heavy"]
    bx = torch.from_numpy(np.ascontiguousarray(boxes[:2, :512]))
    vd = torch.from_numpy(np.ascontiguousarray(valid[:2, :512]))
    assert int(greedy_nms_mask(bx, vd, 0.4).sum()) < int(vd.sum()) // 2
