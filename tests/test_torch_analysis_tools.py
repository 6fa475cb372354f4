"""The port's analysis tools on the CPU (``--device cpu``, WIDTH = DEPTH =
0.25, 64x64, float32): tools/attr_trace.py (scope attribution, also on a
made-up CUDA trace that exercises each way a kernel finds its scope),
tools/check_csp_fused.py (the PALLAS_CSP forward against the plain one)
and tools/act_bound.py (the Mish swap), and each tool's flags against
those of its JAX original."""

import argparse
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.test_torch_helpers import small_cfgs, small_model_pair
from yolov4_tpu_torch.config import Config
from yolov4_tpu_torch.models import build_model, layers
from yolov4_tpu_torch.models.layers import ACTIVATIONS, ConvBNAct
from yolov4_tpu_torch.tools import act_bound, attr_trace, check_csp_fused

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
SIZE = 64
SMALL = {"MODEL": {"WIDTH": 0.25, "DEPTH": 0.25, "COMPUTE_DTYPE": "float32"},
         "TEST": {"IMGSIZE": SIZE}}


def _small_cfg():
    return Config.from_dict({k: dict(v) for k, v in SMALL.items()})


@pytest.fixture(scope="module")
def spread_sd():
    """Weights whose activations stay O(1) (tests/test_torch_helpers.py)."""
    return small_model_pair(seed=4)[4]


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


# --------------------------------------------------------------------------
# attr_trace

@pytest.mark.parametrize("argv", (["--target", "serve"],
                                  ["--target", "fwd", "--with-nms",
                                   "--pallas-csp", "--group-depth", "2"]))
def test_attr_trace_attributes_every_op_to_a_scope(argv, capsys):
    args = attr_trace.build_parser().parse_args(
        argv + ["--device", "cpu", "--img-size", str(SIZE), "--batch", "2",
                "--top", "0"])
    cfg = attr_trace.build_cfg(args, _small_cfg())
    result = attr_trace.run(cfg, args)
    assert _last_json(capsys) == json.loads(json.dumps(result))
    modules = {name or "model" for name, _ in
               build_model(cfg, device="cpu").named_modules()}
    scopes = {scope for _, scope, _ in result["kernels_ms_per_iter"]}
    assert result["unattributed_share"] == 0.0
    assert scopes <= modules | {"input", "postprocess", "run"}
    assert "postprocess" in scopes and any(
        s.startswith("backbone.stage3.") for s in scopes)
    total = result["cpu_op_ms_per_iter"]
    assert total > 0
    assert sum(result["groups_ms_per_iter"].values()) == pytest.approx(
        total, rel=1e-9)
    assert sum(ms for *_, ms in result["kernels_ms_per_iter"]) == \
        pytest.approx(total, rel=1e-9)
    depth = args.group_depth
    assert all(len(g.split(".")) <= depth
               for g in result["groups_ms_per_iter"])


def _x(cat, name, ts, dur, tid, pid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "pid": pid, "args": args}


def test_attr_trace_finds_each_kernels_scope_on_a_cuda_trace():
    """A made-up CUDA trace: a kernel linked to its op by external id, one
    found through its runtime call's correlation id, K2's and K1's
    kernels with no link (each run of unlinked work holding them belongs
    to the call of their custom op in the same place; a memset launched
    inside K1's call with them), and a kernel with no way to a scope."""
    events = [
        _x("user_annotation", "run", 0, 100, 1),
        _x("user_annotation", "backbone.stage1", 10, 50, 1),
        _x("cpu_op", "aten::cudnn_convolution", 20, 10, 1,
           **{"External id": 1}),
        _x("cpu_op", "yolov4_tpu_torch::fused_csp_stage", 40, 10, 1,
           **{"External id": 2}),
        _x("cuda_runtime", "cudaLaunchKernel", 55, 1, 1, correlation=9),
        _x("user_annotation", "postprocess", 70, 25, 1),
        _x("cpu_op", "yolov4_tpu_torch::greedy_nms_mask", 75, 5, 1,
           **{"External id": 3}),
        _x("user_annotation", "not a scope", 76, 2, 1),
        _x("cpu_op", "aten::topk", 85, 5, 1, **{"External id": 4}),
        # the card: stream 7 of device 0
        _x("kernel", "cudnn_conv", 200, 10, 7, 0,
           **{"External id": 1, "correlation": 5}),
        _x("kernel", "csp_wgmma_kernel", 210, 20, 7, 0),
        _x("kernel", "csp_wgmma_kernel", 230, 20, 7, 0),
        _x("kernel", "elementwise", 250, 5, 7, 0, correlation=9),
        _x("kernel", "nms_mask_kernel", 260, 3, 7, 0),
        _x("gpu_memset", "Memset", 263, 1, 7, 0),
        _x("kernel", "nms_scan_kernel", 264, 2, 7, 0),
        _x("kernel", "topk_kernel", 266, 4, 7, 0, **{"External id": 4}),
        _x("kernel", "mystery", 270, 1, 7, 0),
        _x("gpu_user_annotation", "backbone.stage1", 200, 60, 7, 0),
    ]
    names = {"run", "backbone.stage1", "postprocess"}
    rows = attr_trace.attribute(events, names, "cuda")
    got = [(r["name"], r["scope"], r["how"]) for r in rows]
    assert got == [
        ("cudnn_conv", "backbone.stage1", "op"),
        ("csp_wgmma_kernel", "backbone.stage1", "custom_op"),
        ("csp_wgmma_kernel", "backbone.stage1", "custom_op"),
        ("elementwise", "backbone.stage1", "runtime"),
        ("nms_mask_kernel", "postprocess", "custom_op"),
        ("Memset", "postprocess", "custom_op"),
        ("nms_scan_kernel", "postprocess", "custom_op"),
        ("topk_kernel", "postprocess", "op"),
        ("mystery", attr_trace.UNATTRIBUTED, None)]
    summary = attr_trace.summarize(rows, 1, 1)
    assert summary["groups_ms"] == pytest.approx(
        {"backbone": 0.055, "postprocess": 0.010,
         attr_trace.UNATTRIBUTED: 0.001})
    assert summary["unattributed_share"] == pytest.approx(1 / 66)
    # two runs of K2's kernels and one call of its op: no pairing
    rows = attr_trace.attribute(events + [
        _x("kernel", "csp_wgmma_kernel", 280, 1, 7, 0)], names, "cuda")
    assert {r["how"] for r in rows if r["name"].startswith("csp_")} == \
        {None}


# --------------------------------------------------------------------------
# check_csp_fused

def test_check_csp_fused_parity_against_the_plain_forward(spread_sd,
                                                          monkeypatch,
                                                          capsys):
    """On spread weights (tests/test_torch_helpers.py): the PALLAS_CSP
    forward, stages 1-3 through the K2 wrapper (its plain version on the
    CPU), against the plain forward within tests/test_torch_csp.py's
    tolerance (atol = rtol = 1e-4)."""
    calls = []
    real = layers.fused_csp_stage_cuda
    monkeypatch.setattr(layers, "fused_csp_stage_cuda",
                        lambda *a: calls.append(a[2]) or real(*a))
    args = check_csp_fused.build_parser().parse_args(
        ["--device", "cpu", "--img-size", str(SIZE), "--batch", "2",
         "--iters", "1", "--windows", "2"])
    result = check_csp_fused.run(check_csp_fused.build_cfg(args,
                                                           _small_cfg()),
                                 args, state_dict=spread_sd)
    assert _last_json(capsys) == json.loads(json.dumps(result))
    parity = result["parity"]
    assert calls[:3] == [0, 1, 2]
    assert 0 < parity["max_abs_diff"] and parity["within_tol"]
    assert parity["tol"] == 1e-4 and parity["max_rel_err"] <= 1e-4
    assert len(result["plain_ms"]) == len(result["fused_ms"]) == 2
    assert result["timer"] == "host"


# --------------------------------------------------------------------------
# act_bound

def _acts(model):
    return {n: m.act for n, m in model.named_modules()
            if isinstance(m, ConvBNAct)}


@pytest.mark.parametrize("pallas", (False, True))
def test_act_bound_swaps_exactly_the_mish_sites(spread_sd, pallas):
    _, cfg = small_cfgs()
    cfg["MODEL"]["PALLAS_CSP"] = pallas
    model = build_model(cfg, device="cpu")
    model.load_state_dict(spread_sd)
    model.eval()
    x = torch.from_numpy(np.random.default_rng(1).random(
        (2, 3, SIZE, SIZE), dtype=np.float32))
    with torch.inference_mode():
        before = model(x)
    shipped = _acts(model)
    leaky, swapped, kept = act_bound.leaky_copy(model)
    mish = {n for n, a in shipped.items() if a is ACTIVATIONS["mish"]}
    assert mish and set(swapped) | set(kept) == mish
    if pallas:   # stages 1-3 keep theirs in K2
        assert kept and all(n.startswith(("backbone.stage1.",
                                          "backbone.stage2.",
                                          "backbone.stage3."))
                            and ".base." not in n + "." for n in kept)
    else:
        assert kept == []
    copied = _acts(leaky)
    for name, act in shipped.items():
        want = (ACTIVATIONS["leaky_relu"] if name in swapped else act)
        assert copied[name] is want, name
    assert _acts(model) == shipped
    with torch.inference_mode():
        after = model(x)
        changed = leaky(x)
    assert torch.equal(before, after)
    assert not torch.allclose(changed, before)


def test_act_bound_prints_one_json_line(capsys):
    args = act_bound.build_parser().parse_args(
        ["--device", "cpu", "--size", str(SIZE), "--batch", "2",
         "--windows", "1", "--pallas-csp"])
    result = act_bound.run(act_bound.build_cfg(args, _small_cfg()), args)
    out = capsys.readouterr().out.strip().splitlines()
    assert json.loads(out[-1]) == json.loads(json.dumps(result))
    assert sum(line.startswith("{") for line in out) == 1
    assert result["swapped"] + result["kept_in_k2"] == result["mish_sites"]
    assert result["kept_in_k2"] > 0
    assert result["ceiling_ms"] == pytest.approx(
        result["mish_median_ms"] - result["leaky_median_ms"])


# --------------------------------------------------------------------------
# the flags: every flag of the JAX original parses on the port's tool

class _Parsed(Exception):
    pass


def _jax_parser(name, monkeypatch):
    """The parser a JAX tool builds in its main()."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    def capture(self, *args, **kwargs):
        raise _Parsed(self)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(_Parsed) as info:
        mod.main()
    monkeypatch.undo()
    return info.value.args[0]


def _argv(parser):
    """Every optional flag of ``parser`` with a value it accepts."""
    argv = []
    for action in parser._actions:
        if not action.option_strings or action.dest == "help":
            continue
        flag = action.option_strings[0]
        if action.nargs == 0:
            argv.append(flag)
        elif action.choices:
            argv += [flag, str(list(action.choices)[-1])]
        elif action.type is int:
            argv += [flag, "7"]
        else:
            argv += [flag, "somewhere"]
    return argv


@pytest.mark.parametrize("jax_name,tool", (
    ("attr_trace", attr_trace), ("check_csp_fused", check_csp_fused),
    ("exp_act_bound", act_bound)))
def test_tool_accepts_every_flag_of_its_jax_original(jax_name, tool,
                                                     monkeypatch):
    jax_parser = _jax_parser(jax_name, monkeypatch)
    argv = _argv(jax_parser)
    assert argv
    want = vars(jax_parser.parse_args(argv))
    got = vars(tool.build_parser().parse_args(argv))
    for dest, value in want.items():
        assert got[dest] == value, dest
    assert got["device"] == "cuda"


@pytest.mark.parametrize("tool", (attr_trace, check_csp_fused, act_bound))
def test_tool_without_a_card_is_an_error(tool):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        tool.main([])
