"""portbench/spans.py: the program's spans read from a profile, on events
made by hand (as test_pb_trace.py), the harness's reading of the same
events left as it was, and a traced window of each cell on the CPU."""

import json
import shutil
from types import SimpleNamespace

import pytest

from portbench import run as run_mod
from portbench import spans
from portbench.metrics import Context
from portbench.tests import pb_cases as pc
from portbench.tests.pb_small import ROOT, bench
from portbench.trace import parse

WINDOW = {"ph": "X", "cat": "user_annotation", "name": "portbench.window",
          "ts": 0.0, "dur": 10000.0, "tid": 1, "pid": 1, "args": {}}


def _x(cat, name, ts, dur, tid, pid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": float(ts),
            "dur": float(dur), "tid": tid, "pid": pid, "args": args}


def _launch(name, ts, ext):
    return _x("cpu_op", name, ts, 4, 1, **{"External id": ext})


def _detect_events():
    """One dispatch: the upload (pinned copy, H2D), the program (a conv
    linked by External id, K2 through ctypes with no link, a neck kernel
    linked by its runtime call's correlation, a head kernel, K1 in the
    postprocess), then the D2H copy outside every program span."""
    host = [
        WINDOW,
        _x("user_annotation", "portbench.dispatch", 100, 900, 1),
        _x("user_annotation", "predictor.upload", 110, 90, 1),
        _launch("aten::copy_", 120, 1),
        _x("cuda_runtime", "cudaMemcpyAsync", 125, 20, 1, correlation=1),
        _x("user_annotation", "predictor.program", 210, 700, 1),
        _x("user_annotation", "model.backbone", 220, 300, 1),
        _launch("aten::cudnn_convolution", 230, 2),
        _launch("yolov4_tpu_torch::fused_csp_stage", 300, 3),
        _x("cuda_runtime", "cudaLaunchKernel", 302, 2, 1, correlation=3),
        _x("user_annotation", "model.neck", 530, 100, 1),
        _x("cuda_runtime", "cudaLaunchKernel", 540, 5, 1, correlation=4),
        _x("user_annotation", "model.head", 640, 100, 1),
        _launch("aten::sigmoid", 650, 5),
        _x("user_annotation", "postprocess", 750, 150, 1),
        _launch("yolov4_tpu_torch::greedy_nms_mask", 760, 6),
        _launch("aten::copy_", 950, 7),
    ]
    device = [
        _x("gpu_memcpy", "Memcpy HtoD", 2000, 400, 7, 0,
           **{"External id": 1, "correlation": 1}),
        _x("kernel", "sm90_xmma_fprop", 2400, 100, 7, 0,
           **{"External id": 2}),
        _x("kernel", "csp_wgmma_kernel", 2500, 300, 7, 0),
        _x("kernel", "csp_conv_kernel", 2800, 100, 7, 0),
        _x("kernel", "vectorized_elementwise_kernel", 2900, 200, 7, 0,
           correlation=4),
        _x("kernel", "sigmoid_kernel", 3100, 50, 7, 0, **{"External id": 5}),
        _x("kernel", "nms_mask_kernel", 3150, 20, 7, 0),
        _x("kernel", "nms_scan_kernel", 3170, 10, 7, 0),
        _x("gpu_memcpy", "Memcpy DtoH", 3180, 20, 7, 0,
           **{"External id": 7}),
    ]
    return host + device


def _by_span(program):
    return {s: program.device_seconds(s) * 1e6 for s in spans.PROGRAM
            if program.device_seconds(s)}


def test_each_operation_finds_its_span_by_its_launch():
    program = spans.program_spans(_detect_events())
    assert _by_span(program) == pytest.approx({
        "predictor.upload": 400, "predictor.program": 780,
        "model.backbone": 500, "model.neck": 200, "model.head": 50,
        "postprocess": 30})
    # the H2D copy and the conv by External id; the neck by correlation;
    # K2's two kernels and K1's two by their custom op's place; the D2H
    # copy by External id, in no program span
    assert program.how == {"op": 4, "runtime": 1, "custom_op": 4}
    assert program.ops[-1][2] == ()
    assert program.host["predictor.upload"] == pytest.approx([70e-6])
    assert program.host["model.neck"] == pytest.approx([95e-6])


def test_a_k2_kernel_with_no_link_goes_to_the_backbone():
    events = _detect_events()
    program = spans.program_spans(events)
    k2 = [st for (s, d, st), e in zip(
        program.ops, [e for e in events if e["cat"] == "kernel"
                      or e["cat"] == "gpu_memcpy"])
          if e["name"].startswith("csp_")]
    assert k2 == [("predictor.program", "model.backbone")] * 2
    # two runs of K2's kernels for one call of its op: no pairing
    program = spans.program_spans(events + [
        _x("kernel", "csp_wgmma_kernel", 3300, 10, 7, 0)])
    assert program.how["none"] == 3


def test_a_backward_launch_on_another_thread_goes_to_train_backward():
    events = [
        WINDOW,
        _x("user_annotation", "train.forward", 100, 100, 1),
        _launch("aten::cudnn_convolution", 110, 1),
        _x("user_annotation", "train.backward", 300, 500, 1),
        # autograd's device thread
        _x("cpu_op", "ConvolutionBackward0", 400, 10, 9,
           **{"External id": 2}),
        _x("cuda_runtime", "cudaLaunchKernel", 450, 2, 9, correlation=3),
        _x("user_annotation", "train.update", 900, 50, 1),
        _launch("Optimizer.step#Adam.step", 905, 4),
        _x("kernel", "fprop", 1000, 100, 7, 0, **{"External id": 1}),
        _x("kernel", "dgrad", 1200, 300, 7, 0, **{"External id": 2}),
        _x("kernel", "batch_norm_backward", 1500, 100, 7, 0,
           correlation=3),
        _x("kernel", "multi_tensor_apply_kernel", 1700, 50, 7, 0,
           **{"External id": 4}),
    ]
    program = spans.program_spans(events)
    assert [st for *_, st in program.ops] == [
        ("train.forward",), ("train.backward",), ("train.backward",),
        ("train.update",)]
    assert _by_span(program) == pytest.approx({
        "train.forward": 100, "train.backward": 400, "train.update": 50})


def test_device_time_is_clipped_to_the_window():
    events = _detect_events()
    events[0] = dict(WINDOW, dur=2450.0)
    program = spans.program_spans(events)
    assert _by_span(program) == pytest.approx({
        "predictor.upload": 400, "predictor.program": 50,
        "model.backbone": 50})


def _traced(events):
    return parse(list(spans.kineto_tuples(events)))


def test_the_program_spans_leave_the_harness_reading_as_it_was():
    """The same events with and without the program's spans (host ranges,
    and their shadows on the device timeline): the same busy time, device
    operations, idle gaps, benchmark spans and their host time, and every
    accepted per-layer reader's value."""
    plain = [e for e in _detect_events() if e["name"] not in spans.PROGRAM]
    shadows = [_x("gpu_user_annotation", e["name"], 2000, 1200, 7, 0)
               for e in _detect_events() if e["name"] in spans.PROGRAM]
    a, b = _traced(plain), _traced(_detect_events() + shadows)
    for key in ("window_s", "busy_s", "device_ops", "idle_gaps", "spans",
                "span_host"):
        assert getattr(a, key) == getattr(b, key), key
    driver = SimpleNamespace(work=64, window_s=1.0, traced_images=64,
                             forwards=1)
    for w in bench()["workloads"]:
        _, cell, config, traffic = run_mod.load_cell(ROOT, w["name"])
        for m in run_mod.cell_metrics(bench(), cell, True):
            got = [run_mod.read_metric(m["name"], Context(
                cell=cell, config=config, traffic=traffic, trace=t,
                driver=driver)) for t in (a, b)]
            assert got[0] == got[1], (w["name"], m["name"])


def test_the_tracer_reads_what_the_harness_reads(tmp_path):
    """On a real profile: ``kineto_tuples`` of its Chrome trace gives
    ``_kineto_events``' tuples, so ``SpanTracer.trace`` is the harness's
    Trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from portbench.trace import _kineto_events
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("portbench.window"):
            with torch.profiler.record_function("model.neck"):
                torch.ones(8).add_(1).sum()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]

    class Saved:
        """The profile, whose trace can be saved once only."""

        def export_chrome_trace(self, to):
            shutil.copy(path, to)

    assert list(spans.kineto_tuples(events)) == list(_kineto_events(Saved()))
    assert spans.program_spans(events).host["model.neck"][0] > 0


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return pc.make_root(tmp_path_factory)


@pytest.mark.parametrize("cell", sorted(w["name"]
                                        for w in bench()["workloads"]))
def test_a_traced_window_on_the_cpu_reads_the_host_spans_only(root, cell):
    out = spans.run(root, cell, pc.SEED, 1.0, device="cpu")
    kind = run_mod.load_cell(ROOT, cell)[3]["driver"]
    host = {n for n, (_, what) in spans.READINGS[kind].items()
            if what == "host"}
    assert {n for n, v in out["readings"].items() if v is not None} == host
    assert all(out["readings"][n] > 0 for n in host)
    # no device on the CPU: no device time, no share of it
    assert out["span_device_ms"] == {} and out["cover"] == {}
    want = {"detect": {"predictor.upload", "predictor.program",
                       "model.backbone", "model.neck", "model.head",
                       "postprocess"},
            "train": {"train.forward", "train.loss", "train.backward",
                      "train.update", "model.backbone", "model.neck",
                      "model.head"},
            "classify": {"train.forward", "train.backward",
                         "train.update"}}[kind]
    assert set(out["span_host_ms"]) == want
    json.dumps(out)
