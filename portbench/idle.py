"""The card's idle share of a cell's window under a trace of the card's
activity alone, on the card:

    python3 portbench/idle.py --workload <name> --seed <n> --seconds <s>

A traced run (``--trace 1``) records every host op as well, which slows
the host's enqueue and raises the idle share it reads. This records only
CUPTI's device and runtime activity, with no host ops, so the host runs
near its untraced pace; the line gives the window's end-to-end values
beside the share, to be set against an untraced run's. One JSON line:
``busy_s``, ``span_s`` (the first device operation's start to the last
one's end), ``idle_share`` (%, of ``span_s``), ``end_to_end``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from portbench import drivers  # noqa: E402
from portbench.run import load_cell  # noqa: E402
from portbench.trace import (DEVICE_ACTIVITIES, Tracer,  # noqa: E402
                             _kineto_events, _merge)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    args = parser.parse_args(argv)
    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    _, cell, config, traffic = load_cell(ROOT, args.workload)
    driver = drivers.load(traffic["driver"])(config, traffic, args.seed,
                                             "cuda")
    driver.setup()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        driver.window(args.seconds, Tracer(False))
    busy = _merge([(s, s + d) for _, cat, s, d, _ in _kineto_events(prof)
                   if cat in DEVICE_ACTIVITIES])
    busy_s = sum(e - s for s, e in busy) / 1e6
    span_s = (busy[-1][1] - busy[0][0]) / 1e6
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      "busy_s": busy_s, "span_s": span_s,
                      "idle_share": 100.0 * (1.0 - busy_s / span_s),
                      "end_to_end": driver.end_to_end(),
                      "device": torch.cuda.get_device_name()}), flush=True)
    driver.release()
    return 0


if __name__ == "__main__":
    sys.exit(main())
