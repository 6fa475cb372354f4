"""The readings a cell's limits are set from, on the card, at the cell's
own size, in one process:

    python3 portbench/readings.py --workload <name> --seeds 1,2,... \
        [--control-seeds 7,8,9] [--out chiprun_out/readings.jsonl]

For each seed of ``--seeds``, the program's numbers (portbench/check.py)
as a run computes them, after a short window at the cell's own load
(detection) or after the checked steps (training). For each seed of
``--control-seeds``, the control's (each driver's ``control``:
detection, the program with its own int8 path switched on; training,
the reference put in the program's place in float8). With ``--faults``,
the faults of portbench/faults.py planted in the program, on the
control's seeds: half of each batch left out (``half_batch``);
detection, the answer for one image of each batch moved (``altered``);
training, a step that returns its state unchanged (``unchanged``, which
reads 1 by the change's measure). One JSON line
each, with every number the check reads (portbench/check.py), compared
or not, and for training the look behind them (the worst leaves, the
loss gap of each step).
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from portbench import drivers, faults  # noqa: E402
from portbench.run import load_cell  # noqa: E402


def reading(config, traffic, seed, device, kind, seconds):
    """The numbers of one seed: ``kind`` "program", "control" or a fault's
    name."""
    import torch
    wrap = faults.FAULTS[kind] if kind in faults.FAULTS else None
    driver = drivers.load(traffic["driver"])(config, traffic, seed, device,
                                             wrap)
    out = (driver.control(seconds) if kind == "control"
           else driver.readings(seconds))
    del driver
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", default="")
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--faults", default="")
    parser.add_argument("--seconds", type=float, default=1.0)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    _, cell, config, traffic = load_cell(ROOT, args.workload)
    plan = [("program", s) for s in args.seeds.split(",") if s]
    plan += [("control", s) for s in args.control_seeds.split(",") if s]
    for name in (f for f in args.faults.split(",") if f):
        plan += [(name, s) for s in args.control_seeds.split(",") if s]
    out = open(args.out, "a") if args.out else None
    for kind, seed in plan:
        row = {"workload": args.workload, "kind": kind, "seed": int(seed),
               **reading(config, traffic, int(seed), "cuda", kind,
                         args.seconds)}
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
