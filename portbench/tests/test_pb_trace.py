"""portbench/trace.py's reading of a profile, on events made by hand."""

import pytest

from portbench.trace import parse

WINDOW = ("portbench.window", "user_annotation", 0.0, 1000.0, 1)


def test_busy_time_is_the_union_of_device_operations():
    t = parse([WINDOW, ("a", "kernel", 100.0, 200.0, 7),
               ("b", "kernel", 250.0, 100.0, 7),
               ("c", "gpu_memcpy", 900.0, 300.0, 7)])
    assert t.busy_s == pytest.approx(350e-6)      # 100-350 and 900-1000
    assert t.window_s == pytest.approx(1e-3)
    assert t.device_seconds("a") == pytest.approx(200e-6)


def test_span_host_time_leaves_out_runtime_calls_on_its_thread():
    t = parse([WINDOW,
               ("portbench.dispatch", "user_annotation", 10.0, 100.0, 1),
               ("cudaLaunchKernel", "cuda_runtime", 5.0, 10.0, 1),
               ("cudaLaunchKernel", "cuda_runtime", 20.0, 10.0, 1),
               ("cudaLaunchKernel", "cuda_runtime", 25.0, 10.0, 1),
               ("cuLaunchKernel", "cuda_driver", 27.0, 2.0, 1),
               ("cudaLaunchKernel", "cuda_runtime", 50.0, 10.0, 2),
               ("cudaEventSynchronize", "cuda_runtime", 100.0, 30.0, 1),
               ("portbench.dispatch", "user_annotation", 200.0, 50.0, 1)])
    # 10-110 less 10-15, 20-35 and 100-110; the other thread's call stays
    assert t.span_host["portbench.dispatch"] == pytest.approx([70e-6,
                                                              50e-6])
    assert t.spans["portbench.dispatch"] == pytest.approx([100e-6, 50e-6])


def test_idle_gaps_are_named_by_the_host_event_running():
    t = parse([WINDOW, ("k", "kernel", 0.0, 400.0, 7),
               ("aten::copy_", "cpu_op", 390.0, 200.0, 1),
               ("k", "kernel", 600.0, 400.0, 7)])
    assert t.idle_gaps == [("aten::copy_", pytest.approx(200e-6))]


def test_one_window_span_is_required():
    with pytest.raises(RuntimeError):
        parse([("a", "kernel", 0.0, 1.0, 7)])
