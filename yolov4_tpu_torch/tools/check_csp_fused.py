"""Parity and a paired A/B of the ``MODEL.PALLAS_CSP`` forward (CSP stages
1-3 through K2, csrc/csp.cu) against the plain forward: the port's copy of
the JAX package's tools/check_csp_fused.py.

Usage (on a machine with a CUDA card):

    python -m yolov4_tpu_torch.tools.check_csp_fused [--img-size 608]
        [--batch 16] [--iters 20] [--windows 6] [--f32] [--no-bench]
        [--device cuda]

Builds the model of the default config (full width, bfloat16; ``--f32``
float32 with TF32 off) twice on the same seed-0 weights, once with
PALLAS_CSP, and runs both eval forwards (decode included) on the same
float images. The seed-0 init's BN scales (~N(0, 0.01)) shrink the
activations towards 0 stage by stage, which makes its parity weak: ``run``
takes other weights (``state_dict``), as chip_smoke.py passes. Parity:
the max abs difference, the max relative difference (against
max(|plain|, 1e-3), as the JAX tool) and its mean, and the max of
|fused - plain| / (1 + |plain|) against K2's tolerance in chip_smoke.py
(PARITY_TOL). Then ``--windows`` paired windows, plain then fused, each of
``--iters`` forwards between CUDA events: each side's ms per batch and
img/s (medians) and the median of the paired ratios plain / fused. Prints
one JSON line last. With ``--device cpu`` K2's plain version runs (parity
plumbing; the times are not a device's).
"""

from __future__ import annotations

import argparse
import json
import time
from contextlib import nullcontext
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from yolov4_tpu_torch.config import Config, load_config
from yolov4_tpu_torch.models import build_model
from yolov4_tpu_torch.utils.device import resolve_device

# chip_smoke.py's K2_TOL_F32 and K2_TOL_BF16: max |fused - plain| / (1 +
# |plain|) by compute dtype
PARITY_TOL = {"float32": 1e-4, "bfloat16": 0.05}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--img-size", type=int, default=608)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--windows", type=int, default=6)
    p.add_argument("--f32", action="store_true",
                   help="COMPUTE_DTYPE float32 (TF32 off)")
    p.add_argument("--no-bench", action="store_true",
                   help="parity only")
    p.add_argument("--device", default="cuda")
    return p


def build_pair(cfg: Config, device: torch.device,
               state_dict: Optional[Dict[str, torch.Tensor]] = None):
    """(plain, fused): the same weights (``state_dict``, or the seed-0
    init), eval mode, channels-last on a card; the fused model with
    MODEL.PALLAS_CSP."""
    plain = build_model(cfg, device=device)
    if state_dict is not None:
        plain.load_state_dict(state_dict)
    fused_cfg = Config.from_dict({k: dict(v) for k, v in cfg.items()})
    fused_cfg["MODEL"]["PALLAS_CSP"] = True
    fused = build_model(fused_cfg, device=device)
    fused.load_state_dict(plain.state_dict())
    models = []
    for m in (plain, fused):
        m.eval()
        if device.type == "cuda":
            m = m.to(memory_format=torch.channels_last)
        models.append(m)
    return tuple(models)


def parity(a: torch.Tensor, b: torch.Tensor, dtype: str) -> Dict:
    """``b`` (fused) against ``a`` (plain), in float32."""
    a, b = a.float(), b.float()
    d = (b - a).abs()
    rel = d / a.abs().clamp_min(1e-3)
    res = dict(max_abs_diff=float(d.max()), max_rel=float(rel.max()),
               mean_rel=float(rel.mean()),
               max_rel_err=float((d / (1 + a.abs())).max()),
               tol=PARITY_TOL[dtype])
    res["within_tol"] = res["max_rel_err"] <= res["tol"]
    return res


def window_ms(fn, x, iters: int, device: torch.device) -> float:
    """ms per call of ``iters`` calls: CUDA events on a card, the host
    clock (after the last call returned) on the CPU."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(x)
        return (time.perf_counter() - t0) / iters * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn(x)
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / iters


def tf32_off(device: torch.device):
    """TF32 off for the block on a card (a float32 run stays float32)."""
    if device.type != "cuda":
        return nullcontext()
    return torch.backends.cudnn.flags(enabled=True, allow_tf32=False)


def run(cfg: Config, args: argparse.Namespace,
        state_dict: Optional[Dict[str, torch.Tensor]] = None) -> Dict:
    device = resolve_device(args.device)
    dtype = cfg["MODEL"]["COMPUTE_DTYPE"]
    size, b = args.img_size, args.batch
    plain, fused = build_pair(cfg, device, state_dict)
    x = torch.from_numpy(np.random.default_rng(0).random(
        (b, 3, size, size), dtype=np.float32)).to(device)
    x = x.contiguous(memory_format=torch.channels_last)
    matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
    result = {"device": (torch.cuda.get_device_name(device)
                         if device.type == "cuda" else "cpu"),
              "img_size": size, "batch": b, "dtype": dtype}
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        with torch.inference_mode(), tf32_off(device):
            t0 = time.time()
            y0 = plain(x)
            print(f"plain built and ran in {time.time() - t0:.1f}s")
            t0 = time.time()
            y1 = fused(x)
            print(f"fused built and ran in {time.time() - t0:.1f}s")
            result["parity"] = res = parity(y0, y1, dtype)
            print(f"parity: max abs diff {res['max_abs_diff']:.3e}, max rel "
                  f"{res['max_rel']:.3e}, mean rel {res['mean_rel']:.3e}; "
                  f"max |d| / (1 + |plain|) {res['max_rel_err']:.3e} "
                  f"(tolerance {res['tol']:g}: "
                  f"{'within' if res['within_tol'] else 'OUTSIDE'})")
            if not args.no_bench:
                result.update(bench(plain, fused, x, args, device))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
    print(json.dumps(result))
    return result


def bench(plain, fused, x, args: argparse.Namespace,
          device: torch.device) -> Dict:
    """Paired interleaved windows, plain then fused."""
    b = args.batch
    window_ms(plain, x, 3, device)
    window_ms(fused, x, 3, device)
    p_ms, f_ms = [], []
    for _ in range(args.windows):
        p_ms.append(window_ms(plain, x, args.iters, device))
        f_ms.append(window_ms(fused, x, args.iters, device))
    ratios = [p / f for p, f in zip(p_ms, f_ms)]
    out = dict(plain_ms=p_ms, fused_ms=f_ms,
               plain_median_ms=float(np.median(p_ms)),
               fused_median_ms=float(np.median(f_ms)),
               paired_median_ratio=float(np.median(ratios)),
               timer="cuda events" if device.type == "cuda" else "host")
    out["plain_img_s"] = b / out["plain_median_ms"] * 1e3
    out["fused_img_s"] = b / out["fused_median_ms"] * 1e3
    print(f"plain ms/batch: {[round(v, 3) for v in p_ms]}")
    print(f"fused ms/batch: {[round(v, 3) for v in f_ms]}")
    print(f"plain median {out['plain_median_ms']:.3f} ms "
          f"({out['plain_img_s']:.1f} img/s)  fused median "
          f"{out['fused_median_ms']:.3f} ms ({out['fused_img_s']:.1f} img/s)"
          f"  plain / fused paired median {out['paired_median_ratio']:.3f}x")
    return out


def build_cfg(args: argparse.Namespace, cfg: Optional[Config] = None
              ) -> Config:
    """The default config (or ``cfg``), float32 under ``--f32``, PALLAS_CSP
    off (the plain side)."""
    cfg = load_config(None) if cfg is None else cfg
    cfg["MODEL"]["PALLAS_CSP"] = False
    if args.f32:
        cfg["MODEL"]["COMPUTE_DTYPE"] = "float32"
    return cfg


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    args = build_parser().parse_args(argv)
    return run(build_cfg(args), args)


if __name__ == "__main__":
    main()
