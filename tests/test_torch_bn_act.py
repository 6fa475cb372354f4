"""The eval BatchNorm and activation pass (ops/bn_act.py, ops/bn_act_cuda.py,
csrc/bn_act.cu) and its routing in models/layers.ConvBNAct.

On the CPU: the plain version against today's conv -> BatchNorm2d (eval)
-> activation chain, bfloat16 against float32, the op's CPU and fake
implementations, the routing predicate case by case, and a CPU
``torch.export`` of the detection program with no trace of the op. On a
card (marker ``chip``; skips without one): the kernel against the plain
version at the main path's shapes, and its launches a forward. The card's
case runs with ``python -m pytest --noconftest -m chip
tests/test_torch_bn_act.py`` (this file imports no JAX)."""

import pytest
import torch
import torch.nn.functional as F

from yolov4_tpu_torch.config import Config
from yolov4_tpu_torch.engine.predictor import Predictor
from yolov4_tpu_torch.models import layers
from yolov4_tpu_torch.models.layers import ConvBNAct
from yolov4_tpu_torch.ops import bn_act_cuda, kernel_launches, launches_since
from yolov4_tpu_torch.ops.bn_act import batch_norm_act_plain, bn_terms

torch.set_num_threads(1)

OP = torch.ops.yolov4_tpu_torch.batch_norm_act.default


def _site(c_in, c_out, act, bn=True, seed=0):
    """An eval ConvBNAct with BN terms far from the identity."""
    g = torch.Generator().manual_seed(seed)
    m = ConvBNAct(c_in, c_out, 3, act=act, bn=bn).eval()
    with torch.no_grad():
        m.conv.weight.copy_(torch.randn(m.conv.weight.shape, generator=g)
                            * 0.3)
        if bn:
            n = m.norm
            n.weight.copy_(1.0 + 0.3 * torch.randn(c_out, generator=g))
            n.bias.copy_(0.5 * torch.randn(c_out, generator=g))
            n.running_mean.copy_(0.5 * torch.randn(c_out, generator=g))
            n.running_var.copy_(0.5 + torch.rand(c_out, generator=g))
    return m


def _terms(norm):
    return (norm.weight, norm.bias, norm.running_mean, norm.running_var,
            norm.eps)


def _bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    """One bfloat16 ulp at each float32 value (8 significant bits)."""
    _, e = torch.frexp(v.abs().clamp_min(torch.finfo(torch.bfloat16).tiny))
    return torch.ldexp(torch.ones_like(v), e - 8)


def _check_bf16(got: torch.Tensor, f32: torch.Tensor) -> None:
    err = (got.float() - f32).abs()
    assert bool((err <= _bf16_ulp(f32)).all()), float(err.max())


def _check_f32(got: torch.Tensor, want: torch.Tensor, y: torch.Tensor,
               terms) -> None:
    """Within 1e-6, relative, of the size of BN's terms at each element,
    |y scale| + |bias| + |mean scale| (BN's shift cancels them to near zero
    at some elements, where the two orders of the products differ by a few
    ulps of the terms, not of the result)."""
    w, b, mean, var, eps = terms
    scale, _ = bn_terms(w, b, mean, var, eps)
    size = ((y.float() * scale[:, None, None]).abs()
            + (b.abs() + (mean * scale).abs())[:, None, None])
    err = (got.float() - want.float()).abs()
    assert bool((err <= 1e-6 * (want.abs() + size)).all()), \
        float((err / (want.abs() + size)).max())


@pytest.mark.parametrize("act", ["mish", "leaky_relu"])
@pytest.mark.parametrize("memory_format",
                         [torch.contiguous_format, torch.channels_last])
def test_plain_matches_the_chain_in_float32(act, memory_format):
    m = _site(8, 16, act)
    x = torch.randn(2, 8, 12, 12).contiguous(memory_format=memory_format)
    with torch.no_grad():
        want, y = m(x), m.conv(x)
        got = batch_norm_act_plain(y, *_terms(m.norm), act)
    assert got.dtype == torch.float32 and got.stride() == want.stride()
    _check_f32(got, want, y, _terms(m.norm))


@pytest.mark.parametrize("act", ["mish", "leaky_relu"])
def test_plain_bf16_within_one_ulp_of_float32(act):
    m = _site(8, 16, act)
    y = (4.0 * torch.randn(2, 16, 10, 10)).to(torch.bfloat16)
    got = batch_norm_act_plain(y, *_terms(m.norm), act)
    want = batch_norm_act_plain(y.float(), *_terms(m.norm), act)
    assert got.dtype == torch.bfloat16
    _check_bf16(got, want)


def test_plain_mish_asymptote_and_terms():
    w, b = torch.tensor([2.0, 1.0]), torch.tensor([0.0, -1.0])
    mean, var = torch.tensor([0.0, 1.0]), torch.tensor([3.0, 0.25])
    scale, shift = bn_terms(w, b, mean, var, 1e-5)
    torch.testing.assert_close(scale, w / torch.sqrt(var + 1e-5), rtol=0,
                               atol=1e-7)
    torch.testing.assert_close(shift, b - mean * scale, rtol=0, atol=0)
    x = torch.tensor([[50.0, -50.0]]).reshape(1, 2, 1, 1)
    out = batch_norm_act_plain(x, w, b, mean, var, 1e-5, "mish").flatten()
    v = (x.flatten() * scale + shift)
    assert out[0] == v[0]                       # past 20: mish(v) = v
    assert abs(float(out[1])) < 1e-20           # far below: ~ v e^v
    with pytest.raises(ValueError):
        batch_norm_act_plain(x, w, b, mean, var, 1e-5, "relu")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_op_cpu_implementation_is_the_plain_version(dtype):
    m = _site(4, 8, "mish", seed=1)
    x = torch.randn(1, 8, 6, 6).to(dtype).contiguous(
        memory_format=torch.channels_last)
    got = OP(x, *_terms(m.norm), "mish")
    torch.testing.assert_close(
        got, batch_norm_act_plain(x, *_terms(m.norm), "mish"), rtol=0,
        atol=0)
    assert bn_act_cuda.batch_norm_act_cuda.launches == 0


@pytest.mark.parametrize("memory_format",
                         [torch.contiguous_format, torch.channels_last])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fake_keeps_shape_dtype_and_strides(memory_format, dtype):
    from torch._subclasses.fake_tensor import FakeTensorMode
    m = _site(4, 8, "leaky_relu")
    real = torch.randn(2, 8, 5, 7).to(dtype).contiguous(
        memory_format=memory_format)
    with FakeTensorMode() as mode:
        x = mode.from_tensor(real)
        terms = [mode.from_tensor(t) for t in _terms(m.norm)[:4]]
        out = OP(x, *terms, m.norm.eps, "leaky_relu")
    assert out.shape == real.shape and out.dtype == dtype
    assert out.stride() == real.stride()


class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself on a card: the routing predicate's
    device test without one."""

    @property
    def is_cuda(self):
        return True


def _on_card(x):
    return torch.Tensor._make_subclass(_OnCard, x)


ROUTES = {
    "eval_no_grad_mish": (dict(), True),
    "eval_no_grad_leaky": (dict(act="leaky_relu"), True),
    "float32_nchw": (dict(dtype=torch.float32,
                          fmt=torch.contiguous_format), True),
    "grad_enabled": (dict(grad=True), False),
    "training": (dict(train=True), False),
    "int8": (dict(quant="int8"), False),
    "no_bn": (dict(bn=False), False),
    "linear": (dict(act="linear", bn=False), False),
    "cpu": (dict(card=False), False),
    "float16": (dict(dtype=torch.float16), False),
    "other_layout": (dict(fmt="transposed"), False),
}


@pytest.mark.parametrize("case", sorted(ROUTES))
def test_routing_predicate(case, monkeypatch):
    kw, fuses = ROUTES[case]
    m = _site(4, 8, kw.get("act", "mish"), bn=kw.get("bn", True))
    m.train(kw.get("train", False))
    m.quant = kw.get("quant", "none")
    x = torch.randn(2, 8, 6, 6).to(kw.get("dtype", torch.bfloat16))
    fmt = kw.get("fmt", torch.channels_last)
    x = (x.transpose(2, 3) if fmt == "transposed"
         else x.contiguous(memory_format=fmt))
    if kw.get("card", True):
        x = _on_card(x)
    with torch.set_grad_enabled(kw.get("grad", False)):
        assert m._fuses_bn_act(x) is fuses
    # a fusing forward hands the conv's output and the BN to the op, with
    # the site's activation by name; a site whose act was swapped
    # (tools/act_bound.py) hands the swapped one
    calls = []
    monkeypatch.setattr(layers, "batch_norm_act_cuda",
                        lambda y, norm, act: calls.append(act) or y)
    if fuses:
        m.act = layers.ACTIVATIONS["leaky_relu"]
        with torch.no_grad():
            m(_on_card(torch.randn(1, 4, 6, 6).contiguous(
                memory_format=fmt)))
        assert calls == ["leaky_relu"]


def test_wrapper_launches_only_on_an_eager_card_tensor(monkeypatch):
    """ConvBNAct's call launches straight away only on a plain CUDA
    tensor; a CPU tensor, or a tensor subclass such as torch.export's fake
    tensors, goes through the op (here its CPU implementation)."""
    launched = []
    monkeypatch.setattr(bn_act_cuda, "_launch",
                        lambda *args: launched.append(args))
    m = _site(4, 8, "mish", seed=2)
    x = torch.randn(1, 8, 5, 5).to(torch.bfloat16)
    want = batch_norm_act_plain(x, *_terms(m.norm), "mish")
    for arg in (x, _on_card(x)):
        got = bn_act_cuda.batch_norm_act_cuda(arg, m.norm, "mish")
        torch.testing.assert_close(got.as_subclass(torch.Tensor), want,
                                   rtol=0, atol=0)
    assert launched == []


def test_cpu_export_of_the_detection_program_has_no_fused_pass():
    """On the CPU the exported detection program keeps BN and the
    activations as they were: no batch_norm_act node, one batch-norm node
    per ConvBNAct with BN."""
    cfg = Config.from_dict({"MODEL": {"WIDTH": 0.25, "DEPTH": 0.25},
                            "TEST": {"IMGSIZE": 64, "PRE_NMS_TOPK": 64,
                                     "MAX_DETS": 10}})
    pred = Predictor(cfg, img_size=64, batch_size=1, device="cpu")
    example = torch.zeros((1, 3 * 64 * 64), dtype=torch.uint8)
    with torch.no_grad():
        ep = torch.export.export(pred.program(), (example,), strict=False)
    targets = [str(n.target) for n in ep.graph.nodes
               if n.op == "call_function"]
    assert not any("batch_norm_act" in t for t in targets)
    sites = sum(1 for m in pred.model.modules()
                if isinstance(m, ConvBNAct) and m.norm is not None)
    assert sum("batch_norm" in t for t in targets) == sites


# --- on a card ---------------------------------------------------------------

# (N, C, H, W, act): the stem at b64 (608²), a stage-5 site (19²), a neck
# leaky site (76²), and a width no 16-byte vector divides in bfloat16
CARD_SHAPES = [(64, 32, 608, 608, "mish"), (64, 1024, 19, 19, "mish"),
               (64, 256, 76, 76, "leaky_relu"), (4, 12, 9, 9, "mish")]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _card_terms(c, seed):
    g = torch.Generator().manual_seed(seed)
    return [t.cuda() for t in (1.0 + 0.3 * torch.randn(c, generator=g),
                               0.5 * torch.randn(c, generator=g),
                               0.5 * torch.randn(c, generator=g),
                               0.5 + torch.rand(c, generator=g))]


def _launches_a_forward(pallas_csp, train=False):
    cfg = Config.from_dict({"MODEL": {"PALLAS_CSP": pallas_csp}})
    if train:
        from yolov4_tpu_torch.models.yolov4 import build_model
        model = build_model(cfg, device="cuda", train=True).train()
        model = model.to(memory_format=torch.channels_last)
        before = kernel_launches()
        x = torch.rand(2, 3, 128, 128, device="cuda").contiguous(
            memory_format=torch.channels_last)
        with torch.autocast("cuda", dtype=torch.bfloat16):
            out = model(x)
        sum(o["output"].float().sum() for o in out).backward()
        return launches_since(before)["batch_norm_act"]
    pred = Predictor(cfg, img_size=128, batch_size=2, device="cuda")
    images = torch.randint(0, 256, (2, 128, 128, 3), dtype=torch.uint8,
                           device="cuda")
    before = kernel_launches()
    pred.run(images)
    torch.cuda.synchronize()
    return launches_since(before)["batch_norm_act"]


@pytest.mark.chip
def test_kernel_equals_the_plain_version_on_the_card(card):
    """bfloat16 within one ulp of the plain version's float32 result,
    float32 to 1e-6 relative, channels-last and contiguous NCHW, at the
    stem's, stage 5's and a neck site's shapes; then 73 launches a
    detect forward with K2, 107 without, 0 in a train step."""
    for i, (n, c, h, w, act) in enumerate(CARD_SHAPES):
        terms = _card_terms(c, i)
        base = torch.randn(n, c, h, w, device=card, dtype=torch.bfloat16)
        for fmt in (torch.channels_last, torch.contiguous_format):
            for dtype in (torch.bfloat16, torch.float32):
                x = (3.0 * base).to(dtype).contiguous(memory_format=fmt)
                got = OP(x, *terms, 1e-5, act)
                assert got.stride() == x.stride()
                f32 = batch_norm_act_plain(x.float(), *terms, 1e-5, act)
                if dtype == torch.bfloat16:
                    _check_bf16(got, f32)
                else:
                    _check_f32(got, f32, x, (*terms, 1e-5))
                del x, got, f32
        del base
        torch.cuda.empty_cache()
    assert _launches_a_forward(True) == 73
    assert _launches_a_forward(False) == 107
    assert _launches_a_forward(False, train=True) == 0
