"""The port's serving export (utils/export.py, tools/export_serving.py) on
the CPU: the cases of tests/test_export.py (round trip bit-identical to the
live predictor, the header contract, the float32 wire, bad files), each
package refusing the other's file at the magic, and a ``PALLAS_CSP``
export whose K2 and K1 are the custom ops, their plain versions here.

The artifact is the live predictor's device program (engine/predictor.py's
``detection_program``) serialized, so a reloaded artifact must give the
same bits."""

import struct

import numpy as np
import pytest
import torch

from yolov4_tpu.utils.export import MAGIC as JAX_MAGIC
from yolov4_tpu.utils.export import ServingArtifact as JaxServingArtifact
from yolov4_tpu_torch.config import Config
from yolov4_tpu_torch.engine.predictor import Predictor, pack_wire
from yolov4_tpu_torch.ops import csp_cuda
from yolov4_tpu_torch.ops.csp import (fused_csp_stage_plain, pack_weights,
                                      packed_dtype, unpack_weights)
from yolov4_tpu_torch.tools import export_serving as export_cli
from yolov4_tpu_torch.utils.export import (MAGIC, ServingArtifact,
                                           export_serving, load_serving)

torch.set_num_threads(1)

SMALL = {"MODEL": {"WIDTH": 0.25, "DEPTH": 0.25, "COMPUTE_DTYPE": "float32"},
         "TEST": {"IMGSIZE": 64, "PRE_NMS_TOPK": 64, "MAX_DETS": 10}}


def _cfg(**model_over):
    raw = {k: dict(v) for k, v in SMALL.items()}
    raw["MODEL"].update(model_over)
    return Config.from_dict(raw)


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """The CLI's export of the seed-0 small model (its --selfcheck holds the
    reloaded file bit-identical to the live predictor), and that live
    predictor."""
    import yaml
    tmp = tmp_path_factory.mktemp("export")
    cfg_path = tmp / "small.cfg"
    cfg_path.write_text(yaml.safe_dump(SMALL))
    path = str(tmp / "model.y4t")
    header = export_cli.main([path, "--cfg", str(cfg_path), "--img-size",
                              "64", "--batch-size", "2", "--device", "cpu",
                              "--selfcheck"])
    live = Predictor(_cfg(), img_size=64, batch_size=2, device="cpu",
                     conf_thre=header["conf_thre"],
                     nms_thre=header["nms_thre"])
    return dict(path=path, header=header, live=live)


def test_roundtrip_bit_identical(exported):
    art = load_serving(exported["path"], device="cpu")
    live = exported["live"]
    imgs = np.random.default_rng(0).integers(0, 256, (2, 64, 64, 3),
                                             np.uint8)
    got = art.predict(imgs)
    want = live.fetch_local(live.dispatch(imgs))
    assert len(got) == len(exported["header"]["outputs"]) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # short batches unpad like the live path
    one = art.predict(imgs[:1])
    assert one[0].shape[0] == 1
    np.testing.assert_array_equal(one[0][0], got[0][0])


def test_header_records_serving_contract(exported):
    header = exported["header"]
    art = ServingArtifact(exported["path"], device="cpu")
    assert art.meta == header
    assert header["img_size"] == 64
    assert header["batch_size"] == 2
    assert header["wire_dtype"] == "uint8"
    assert header["outputs"][:2] == ["detections", "valid"]
    assert header["s2d_wire"] is False
    assert header["platforms"] == ["cpu"] and header["device"] == "cpu"
    assert header["quant"] == "none"
    assert header["torch_version"] == torch.__version__
    assert header["max_dets"] == 10 and header["num_classes"] == 80
    # the default device is CUDA, and an artifact runs where it was made
    with pytest.raises(RuntimeError, match="CUDA"):
        load_serving(exported["path"])


def test_bad_file_rejected(tmp_path):
    p = tmp_path / "junk.y4t"
    p.write_bytes(b"NOTMAGIC" + b"\x00" * 64)
    with pytest.raises(ValueError, match="not a yolov4_tpu_torch"):
        ServingArtifact(str(p), device="cpu")
    p2 = tmp_path / "badver.y4t"
    p2.write_bytes(MAGIC + bytes([99]) + b"\x00" * 16)
    with pytest.raises(ValueError, match="version"):
        ServingArtifact(str(p2), device="cpu")


def test_each_package_refuses_the_others_artifact(exported, tmp_path):
    assert MAGIC != JAX_MAGIC
    hdr = b'{"img_size": 64}'
    jax_file = tmp_path / "jax.y4x"
    jax_file.write_bytes(JAX_MAGIC + bytes([1]) + struct.pack("<I", len(hdr))
                         + hdr + b"\x00" * 32)
    with pytest.raises(ValueError, match="not a yolov4_tpu_torch"):
        ServingArtifact(str(jax_file), device="cpu")
    with pytest.raises(ValueError, match="not a yolov4_tpu serving"):
        JaxServingArtifact(exported["path"])


def test_fused_bf16_float32_wire_export(tmp_path, monkeypatch):
    """MODEL.PALLAS_CSP in bfloat16, float32 wire: the program carries K2
    three times and K1 once as custom ops, which run their plain versions
    here; the reloaded artifact is bit-identical to the live program on
    the same float wire; the wire dtype is enforced."""
    pred = Predictor(_cfg(PALLAS_CSP=True, COMPUTE_DTYPE="bfloat16"),
                     img_size=64, batch_size=2, device="cpu")
    path = str(tmp_path / "fused.y4t")
    header = export_serving(pred, path, wire_dtype=np.float32)
    assert header["wire_dtype"] == "float32"
    art = load_serving(path, device="cpu")
    targets = [str(n.target) for n in art._program.graph.nodes
               if n.op == "call_function"]
    assert sum("fused_csp_stage" in t for t in targets) == 3
    assert sum("greedy_nms_mask" in t for t in targets) == 1
    calls = []
    real = csp_cuda.fused_csp_stage_plain
    monkeypatch.setattr(csp_cuda, "fused_csp_stage_plain",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    imgs = np.random.default_rng(1).random((2, 64, 64, 3), np.float32)
    got = art.predict(imgs)
    assert calls == [(2, 32, 32, 16), (2, 16, 16, 32), (2, 8, 8, 64)]
    want = pred.run_wire(torch.from_numpy(pack_wire(imgs, 2)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())
    assert got[1].any()
    with pytest.raises(ValueError, match="wire dtype"):
        art.predict((imgs * 255).astype(np.uint8))


def _conv_shapes(c, nb):
    """(ci, co, k) of each conv of a stage body, by folded-dict name
    (ops/csp.py's docstring)."""
    c2 = c // 2
    if nb == 0:
        return {"part1": (c, c, 1), "part2_1_1": (c, c, 1),
                "part2_1_2_0": (c, c2, 1), "part2_1_2_1": (c2, c, 3),
                "part2_2": (c, c, 1), "transition": (2 * c, c, 1)}
    out = {"part1": (c, c2, 1), "part2_0": (c, c2, 1)}
    for i in range(nb):
        out[f"block{i}_0"] = (c2, c2, 1)
        out[f"block{i}_1"] = (c2, c2, 3)
    out.update(part2_2=(c2, c2, 1), transition=(c, c, 1))
    return out


@pytest.mark.parametrize("c,nb", [(16, 0), (24, 3), (18, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_csp_op_cpu_implementation_is_the_plain_version(c, nb, dtype):
    """K2's op on the CPU reads its weights back from the float32 packed
    list (ops/csp.unpack_weights, a reshape) and runs the plain version:
    bit-equal to the plain version on the folded weights, which rounds the
    kernels to x's dtype itself."""
    g = torch.Generator().manual_seed(c + nb)
    folded = {name: (torch.randn((k, k, ci, co), generator=g)
                     / (k * k * ci) ** 0.5, torch.rand(co, generator=g) - 0.5)
              for name, (ci, co, k) in _conv_shapes(c, nb).items()}
    x = torch.randn((2, 5, 7, c), generator=g).to(dtype)
    packed = pack_weights(folded, nb, packed_dtype(x))
    assert packed[0].dtype == torch.float32
    unpacked = unpack_weights(packed, c, nb)
    for name, (kernel, bias) in folded.items():
        assert torch.equal(unpacked[name][0], kernel), name
        assert torch.equal(unpacked[name][1], bias), name
    got = csp_cuda.fused_csp_stage_cuda(x, folded, nb, packed)
    assert csp_cuda.fused_csp_stage_cuda.launches == 0
    assert torch.equal(got, fused_csp_stage_plain(x, folded, nb))
