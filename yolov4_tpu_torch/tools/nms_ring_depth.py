"""Time K1's scan launch at several depths of its shared-memory slab ring.

Usage (on a machine with a CUDA card and the CUDA toolkit):

    python -m yolov4_tpu_torch.tools.nms_ring_depth [--depths 2 3] [--rounds 4]

Builds ``csrc/nms.cu`` once for each depth (``-DNMS_SCAN_SLOTS=<depth>``;
the package's own build uses the source's default) and, at the main path's
shape (B=16, K=2048, t=0.4), times the scan launch alone on one pair mask
for two inputs: class-offset boxes that all survive (as the main path's
with random weights) and a suppression-heavy input (4 classes over a 50 px
spread, valid_p 0.9). A time is the median of CUDA events around one launch
with a spin kernel queued ahead, so that the host's enqueue is not timed;
the depths take turns, in reverse order every other round. Each depth's
keep mask must equal the plain version's. Prints a line per input and
depth, then one JSON line.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from yolov4_tpu_torch.ops import nms_cuda
from yolov4_tpu_torch.ops.nms import greedy_nms_mask

B, K, THRESH = 16, 2048, 0.4


def device_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Median device time of one call of ``fn``, the queue filled ahead."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1_000_000)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def inputs(seed: int = 0) -> dict:
    """{name: (boxes [B, K, 4] float32, valid [B, K] bool)} on the host."""
    r = np.random.default_rng(seed)
    # 80 classes, offset apart; no two boxes meet: every candidate survives
    x = np.broadcast_to(np.arange(K, dtype=np.float32)[None, :, None] * 40.0,
                        (B, K, 1))
    y = r.uniform(0, 600, (B, K, 1)).astype(np.float32)
    kept = np.concatenate([x, y, x + 30.0, y + 30.0], -1)
    kept = kept + r.integers(0, 80, (B, K, 1)) * np.float32(1e5)
    # few classes over a small spread: most candidates are suppressed
    c = r.uniform(0, 50, (B, K, 2)).astype(np.float32)
    wh = r.uniform(15, 160, (B, K, 2)).astype(np.float32)
    heavy = np.concatenate([c, c + wh], -1)
    span = np.float32(2.0 * np.abs(heavy).max() + 1.0)
    heavy = heavy + r.integers(0, 4, (B, K, 1)) * span
    return {"all_kept": (kept.astype(np.float32), np.ones((B, K), bool)),
            "suppression_heavy": (heavy.astype(np.float32),
                                  r.random((B, K)) < 0.9)}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--depths", type=int, nargs="+", default=[2, 3])
    parser.add_argument("--rounds", type=int, default=4)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("nms_ring_depth needs a CUDA card")
    flags = {d: (*nms_cuda.NVCC_FLAGS, f"-DNMS_SCAN_SLOTS={d}")
             for d in args.depths}
    for d, f in flags.items():
        if nms_cuda.scan_slots(K, f) != d:
            raise AssertionError(f"depth {d}: the build reports "
                                 f"{nms_cuda.scan_slots(K, f)} slots at K={K}")
    result = {"device": torch.cuda.get_device_name(0), "b": B, "k": K,
              "t": THRESH, "scan_ms": {}}
    for name, (boxes, valid) in inputs().items():
        bx = torch.from_numpy(boxes).cuda()
        vd = torch.from_numpy(valid).cuda()
        want = greedy_nms_mask(bx, vd, THRESH)
        mask = nms_cuda.pair_mask_words_cuda(bx, THRESH)
        for d, f in flags.items():
            got = nms_cuda.scan_mask_words_cuda(mask, vd, f)
            if not torch.equal(got, want):
                raise AssertionError(f"{name}: depth {d} differs from the "
                                     f"plain version")
        times = {d: [] for d in flags}
        for rnd in range(args.rounds):
            order = list(flags) if rnd % 2 == 0 else list(flags)[::-1]
            for d in order:
                times[d].append(device_ms(
                    lambda: nms_cuda.scan_mask_words_cuda(mask, vd, flags[d])))
        result["scan_ms"][name] = {str(d): ts for d, ts in times.items()}
        for d, ts in times.items():
            print(f"{name} ({int(want.sum())} of {int(valid.sum())} valid "
                  f"kept): {d} slots, scan {float(np.median(ts)):.4f} ms "
                  f"(rounds {', '.join(f'{t:.4f}' for t in ts)})")
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
