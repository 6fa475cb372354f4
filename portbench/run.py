"""Run one cell of the benchmark once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout. The cell (``BENCHMARK.json``'s
``workloads``) names its configuration (``portbench/configs/``) and its
traffic (``portbench/traffic/<traffic>.json``), which names its driver
(``portbench/drivers/<driver>.py``). In order: the weights and inputs are
made on the card from the seed, the program is built and the cell's own
shapes warmed (``setup_s``, from the process's start), the window runs
for ``--seconds`` (with ``--trace 1`` under the profiler, at most
``TRACE_SECONDS``), the program's state is freed, the reference checks
the outputs, and the last line of standard output is
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``
(the cell's end-to-end metrics, or with ``--trace 1`` its per-layer
ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, each compared number beside its limit.

Exits 1 without a result when there is no CUDA card, fewer cards than
the cell asks for, or ``jax``, ``jaxlib``, ``flax`` or ``yolov4_tpu`` is
loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the program's and the benchmark's packages, from the checkout's root
sys.path.insert(0, ROOT)

# build and kernel caches inside the checkout, at fixed paths (the
# program's own kernels build into yolov4_tpu_torch/_build/)
CACHE = os.path.join(ROOT, ".portbench_cache")
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = os.path.join(CACHE, sub)

FORBIDDEN = ("jax", "jaxlib", "flax", "yolov4_tpu")
# the longest traced window: the profiler's trace of a longer one takes
# more memory and time to read than a run is allowed
TRACE_SECONDS = 8.0


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, whole, is forbidden."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def load_cell(root: str, workload: str):
    """(bench, cell, config, traffic) for a workload of BENCHMARK.json."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    with open(os.path.join(root, configs[cell["config"]]["file"])) as f:
        config = json.load(f)
    with open(os.path.join(root, "portbench", "traffic",
                           f"{cell['traffic']}.json")) as f:
        traffic = json.load(f)
    return bench, cell, config, traffic


def cell_metrics(bench: dict, cell: dict, trace: bool) -> list:
    """The metric entries this cell reports: its end-to-end ones, or with
    ``trace`` its per-layer ones."""
    def applies(m):
        return "workloads" not in m or cell["name"] in m["workloads"]
    e2e = [m for m in bench["end_to_end"] if applies(m)]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if applies(m) and m["moves"] in names]


def read_metric(name: str, ctx) -> float | None:
    """Run ``portbench/metrics/<name>.py``'s ``read(ctx)``."""
    import importlib.util
    path = os.path.join(ROOT, "portbench", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


def run(root: str, workload: str, seed: int, seconds: float, trace: bool,
        device="cuda", wrap=None, limits=None):
    """One run of a cell: returns (result dict, stderr lines). ``root``
    holds ``BENCHMARK.json`` and the cell's data files; the code (drivers,
    metric readers) is this package's. ``device``, ``wrap`` and ``limits``
    are for the tests (the CLI runs on the card with the cell's limits)."""
    import torch

    from portbench import check, drivers
    from portbench.metrics import Context
    from portbench.trace import Tracer

    bench, cell, config, traffic = load_cell(root, workload)
    t_imports = time.perf_counter() - T_START
    driver = drivers.load(traffic["driver"])(config, traffic, seed, device,
                                             wrap)
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    driver.setup()
    setup_s = time.perf_counter() - T_START
    tracer = Tracer(trace)
    window = min(seconds, TRACE_SECONDS) if trace else seconds
    driver.window(window, tracer)
    peak = (torch.cuda.max_memory_allocated(device)
            if torch.device(device).type == "cuda" else 0)
    driver.release()
    t = time.perf_counter()
    per_item = driver.check()
    check_s = time.perf_counter() - t
    numbers = {k: max(v) for k, v in per_item.items()}
    if limits is None:
        limits = check.load_limits(root, workload)
    checks = check.verdict(numbers, limits)
    # checked items (images, steps) outside a limit: all of them where a
    # number pooled over the items is
    items = max(len(per_item[k]) for k in limits)
    failed = items if any(len(per_item[k]) < items and not
                          checks[k]["value"] <= limits[k] for k in limits) \
        else sum(any(len(per_item[k]) == items and not per_item[k][i] <=
                     limits[k] for k in limits) for i in range(items))
    values = dict(driver.end_to_end(), setup_s=setup_s)
    ctx = Context(cell=cell, config=config, traffic=traffic,
                  trace=tracer.trace, driver=driver)
    metrics = {}
    for m in cell_metrics(bench, cell, trace):
        value = values.get(m["name"]) if not trace else read_metric(
            m["name"], ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if torch.device(device).type == "cuda"
           else torch.device(device).type,
           "kind": (torch.cuda.get_device_name(device)
                    if torch.device(device).type == "cuda" else "cpu"),
           "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    result = {"correct": check.is_correct(checks),
              "attempted": int(driver.attempted), "failed": int(failed),
              "metrics": metrics, "device": dev}
    if trace:
        tr = tracer.trace
        dev["busy_s"], dev["window_s"] = tr.busy_s, tr.window_s
        result["breakdown"] = {"device_ops": [[n, s] for n, s in
                                              tr.top_ops(10)],
                               "idle_gaps": [[n, s] for n, s in
                                             tr.idle_gaps]}
    result["checks"] = checks
    parts = dict(imports=t_imports, **driver.setup_parts)
    notes = [
        "setup_s parts: " + ", ".join(f"{k} {v:.3f} s" for k, v in
                                      parts.items())
        + f"; total {setup_s:.3f} s",
        f"window {driver.window_s:.3f} s, {driver.attempted} attempted, "
        f"{driver.work} images in the window; check {check_s:.3f} s",
    ] + [f"check {k}: {c['value']:.6g} (limit {c['limit']:.6g})"
         for k, c in checks.items()]
    return result, notes


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    import torch
    _, cell, _, _ = load_cell(ROOT, args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"{torch.cuda.device_count()} CUDA devices, the cell asks "
              f"for {cell['chips']}", file=sys.stderr)
        return 1
    result, notes = run(ROOT, args.workload, args.seed, args.seconds,
                        bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}",
              file=sys.stderr)
        return 1
    print(json.dumps(result), flush=True)
    for line in notes:
        print(line, file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
