"""The port's spans (utils/profiling.py) on the CPU, WIDTH = DEPTH = 0.25,
64x64, float32: the shared no-op without a profiler; under one, the
Predictor's and the train steps' spans nested as the layers are, read
back through the shared attribution and StepProfiler's spans.txt; an
export traced under a profiler holds no profiler op; and the attribution's
rules on events made by hand."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from yolov4_tpu_torch.classify.trainer import make_cls_train_step
from yolov4_tpu_torch.config import Config
from yolov4_tpu_torch.engine.predictor import Predictor
from yolov4_tpu_torch.models import build_model
from yolov4_tpu_torch.models.darknet import CSPDarknet53
from yolov4_tpu_torch.ops.loss import build_criterion
from yolov4_tpu_torch.optim import build_optimizer
from yolov4_tpu_torch.parallel.train_step import TrainState, make_train_step
from yolov4_tpu_torch.tools.profile_train import random_batch
from yolov4_tpu_torch.utils import profiling
from yolov4_tpu_torch.utils.profiling import (NOOP, SPANS, StepProfiler,
                                              attribute, chrome_events,
                                              open_scopes, span, span_host,
                                              span_table)

torch.set_num_threads(1)

SIZE = 64
SMALL = {"MODEL": {"WIDTH": 0.25, "DEPTH": 0.25, "COMPUTE_DTYPE": "float32"},
         "TEST": {"IMGSIZE": SIZE}}


def _cfg():
    return Config.from_dict({k: dict(v) for k, v in SMALL.items()})


def _images(n=2, seed=0):
    return np.random.default_rng(seed).integers(
        0, 256, (n, SIZE, SIZE, 3), dtype=np.uint8)


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return chrome_events(prof)


def _annotations(events):
    """{name: [(start, end, tid)]} of the program's spans."""
    out = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation" \
                and e["name"] in SPANS:
            out.setdefault(e["name"], []).append(
                (e["ts"], e["ts"] + e["dur"], e["tid"]))
    return out


def _inside(inner, outer):
    return (inner[2] == outer[2] and outer[0] <= inner[0]
            and inner[1] <= outer[1])


@pytest.fixture(scope="module")
def predictor():
    return Predictor(_cfg(), img_size=SIZE, batch_size=2, device="cpu")


def test_span_without_a_profiler_is_the_shared_noop(predictor):
    assert span("model.backbone") is NOOP and span("anything") is NOOP
    predictor(_images())                    # every span runs as the no-op
    events = _profiled(lambda: torch.ones(3) + 1)
    assert _annotations(events) == {}


def test_predictor_spans_nest_under_a_profiler(predictor):
    events = _profiled(lambda: predictor.fetch_local(
        predictor.dispatch(_images())))
    spans = _annotations(events)
    assert set(spans) == {"predictor.upload", "predictor.program",
                          "model.backbone", "model.neck", "model.head",
                          "postprocess"}
    assert all(len(v) == 1 for v in spans.values())
    (upload,), (program,) = spans["predictor.upload"], \
        spans["predictor.program"]
    assert upload[1] <= program[0]
    parts = [spans[n][0] for n in ("model.backbone", "model.neck",
                                   "model.head", "postprocess")]
    assert all(_inside(p, program) for p in parts)
    assert all(a[1] <= b[0] for a, b in zip(parts, parts[1:]))
    rows = attribute(events, set(SPANS), "cpu")
    stacks = {r["scopes"] for r in rows}
    assert {("predictor.program", "model.backbone"),
            ("predictor.program", "postprocess")} <= stacks
    table = span_table(events, "cpu")
    assert all(table[n]["calls"] == 1 for n in spans)
    children = sum(table[n]["work_ms"] for n in ("model.backbone",
                                                 "model.neck", "model.head",
                                                 "postprocess"))
    assert 0 < children <= table["predictor.program"]["work_ms"] \
        <= table["(all)"]["work_ms"]
    assert all(table[n]["host_ms"] > 0 for n in spans)


def _detector_step():
    cfg = _cfg()
    model = build_model(cfg, device="cpu", train=True)
    optimizer = build_optimizer(cfg, model)
    step = make_train_step(model, build_criterion(cfg), optimizer,
                           lambda _: 1e-4)
    images, labels = random_batch(2, SIZE, device="cpu")
    return lambda state: step(state, images, labels)


def _classifier_step():
    model = CSPDarknet53(4, width=0.25, depth=0.25,
                         generator=torch.Generator().manual_seed(0))
    optimizer = torch.optim.Adam(model.parameters(), lr=1e-4)
    step = make_cls_train_step(model, optimizer, lambda _: 1e-4)
    u8 = torch.from_numpy(_images())
    labels = torch.tensor([0, 3])
    return lambda state: step(state, u8, labels)


@pytest.mark.parametrize("kind,phases", (
    ("detector", ("train.forward", "train.loss", "train.backward",
                  "train.update")),
    ("classifier", ("train.forward", "train.backward", "train.update"))))
def test_train_step_spans_follow_its_phases(kind, phases):
    step = _detector_step() if kind == "detector" else _classifier_step()
    state = step(TrainState())
    events = _profiled(lambda: step(state))
    spans = _annotations(events)
    model_spans = ({"model.backbone", "model.neck", "model.head"}
                   if kind == "detector" else set())
    assert set(spans) == set(phases) | model_spans
    order = [spans[p][0] for p in phases]
    assert all(len(spans[p]) == 1 for p in phases)
    assert all(a[1] <= b[0] for a, b in zip(order, order[1:]))
    for name in model_spans:
        assert _inside(spans[name][0], spans["train.forward"][0])
    table = span_table(events, "cpu")
    assert all(table[p]["work_ms"] > 0 for p in phases)


def test_step_profiler_writes_the_spans_of_its_window(tmp_path):
    step = _detector_step()
    state = TrainState()
    prof = StepProfiler(str(tmp_path), start=1, count=2)
    for k in range(1, 5):
        state = step(state)
        prof.on_step(k)
    prof.close()
    assert {p.name for p in tmp_path.iterdir()} == {"trace.json",
                                                    "kernels.txt",
                                                    "spans.txt"}
    lines = (tmp_path / "spans.txt").read_text().splitlines()
    assert lines[0].split()[:2] == ["span", "calls"]
    rows = {line.split()[0]: line.split()[1:] for line in lines[1:]}
    for name in ("train.forward", "train.loss", "train.backward",
                 "train.update", "model.backbone"):
        calls, work, host = rows[name][:3]
        assert int(calls) == 2 and float(work) > 0 and float(host) > 0
    assert "(all)" in rows and "predictor.program" not in rows


def test_export_under_a_profiler_holds_no_profiler_op(predictor):
    example = torch.zeros((2, 3 * SIZE * SIZE), dtype=torch.uint8)
    with profile(activities=[ProfilerActivity.CPU]):
        with torch.no_grad():
            exported = torch.export.export(predictor.program(), (example,),
                                           strict=False)
    targets = [str(n.target) for n in exported.graph.nodes
               if n.op == "call_function"]
    assert targets and not any("profiler" in t or "record_function" in t
                               for t in targets)
    out = exported.module()(example)
    want = predictor.run_wire(example)
    assert all(torch.equal(a, b) for a, b in zip(out, want))


# --------------------------------------------------------------------------
# the attribution's rules on events made by hand

def _x(cat, name, ts, dur, tid, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "pid": 1, "args": args}


def test_open_scopes_nest_and_fall_back_to_the_thread_holding_a_span():
    spans = [_x("user_annotation", "a", 0, 100, 1),
             _x("user_annotation", "b", 10, 10, 1),
             _x("user_annotation", "c", 30, 10, 1),
             _x("user_annotation", "train.backward", 200, 100, 1),
             _x("user_annotation", "other", 250, 30, 3)]
    got = open_scopes(spans, [(1, 15), (1, 35), (1, 50), (1, 150),
                              (2, 220), (2, 260), (2, 400)])
    assert got == [("a", "b"), ("a", "c"), ("a",), (),
                   ("train.backward",), ("other",), ()]


def test_backward_launch_on_another_thread_goes_to_train_backward():
    events = [
        _x("user_annotation", "train.forward", 0, 50, 1),
        _x("cpu_op", "aten::mul", 10, 5, 1, **{"External id": 1}),
        _x("user_annotation", "train.backward", 60, 100, 1),
        # autograd's device thread
        _x("cpu_op", "MulBackward0", 70, 5, 9, **{"External id": 2}),
        _x("cuda_runtime", "cudaLaunchKernel", 80, 2, 9, correlation=5),
        _x("kernel", "fwd_kernel", 300, 10, 7, **{"External id": 1}),
        _x("kernel", "bwd_kernel", 320, 10, 7, **{"External id": 2}),
        _x("kernel", "bwd_fill", 340, 10, 7, correlation=5),
    ]
    rows = attribute(events, {"train.forward", "train.backward"}, "cuda")
    assert [(r["name"], r["scope"], r["how"]) for r in rows] == [
        ("fwd_kernel", "train.forward", "op"),
        ("bwd_kernel", "train.backward", "op"),
        ("bwd_fill", "train.backward", "runtime")]


def test_span_host_leaves_out_runtime_calls_on_its_thread():
    events = [_x("user_annotation", "predictor.upload", 10, 100, 1),
              _x("cuda_runtime", "cudaLaunchKernel", 5, 10, 1),
              _x("cuda_runtime", "cudaLaunchKernel", 20, 10, 1),
              _x("cuda_runtime", "cudaLaunchKernel", 25, 10, 1),
              _x("cuda_driver", "cuLaunchKernel", 27, 2, 1),
              _x("cuda_runtime", "cudaLaunchKernel", 50, 10, 2),
              _x("cuda_runtime", "cudaHostAlloc", 100, 30, 1),
              _x("user_annotation", "predictor.upload", 200, 50, 1),
              _x("user_annotation", "not a span", 0, 300, 1)]
    # 10-110 less 10-15, 20-35 and 100-110; the other thread's call stays
    assert span_host(events, SPANS) == {
        "predictor.upload": pytest.approx([70.0, 50.0])}
    assert profiling.format_span_table(
        span_table(events, "cuda"), "cuda").splitlines()[1].split()[:2] == \
        ["predictor.upload", "2"]
