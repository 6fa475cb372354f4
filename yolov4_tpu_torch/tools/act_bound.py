"""What Mish costs the eval forward at most: the port's copy of the JAX
package's tools/exp_act_bound.py.

Usage (on a machine with a CUDA card):

    python -m yolov4_tpu_torch.tools.act_bound [--size 608] [--batch 16]
        [--quant none|int8|int8_static] [--windows 6] [--pallas-csp]
        [--device cuda]

Takes the model of the default config (full width, bfloat16, seed-0
weights) twice: as shipped, and a copy in which every Mish site
(models/layers.ConvBNAct with act "mish") computes leaky ReLU 0.1
instead; weights, layout and convolutions are the same, and the shipped
model is left as it was. Times forward + decode of both in paired
interleaved windows (ITERS calls each between CUDA events, shipped then
leaky) and prints both medians and the ceiling, shipped minus leaky: no
cheaper Mish (an approximation, a table) can save more than replacing it
by a select. A probe, not a model option: leaky for Mish changes the
numerics entirely. With ``--pallas-csp`` the bodies of CSP stages 1-3 run
in K2, whose Mish stays: only the sites outside K2 are swapped, and the
count is printed. On a card every eval ConvBNAct with BN runs BN and its
activation as one pass of the batch_norm_act kernel (ops/bn_act_cuda.py),
Mish and leaky alike, at the same bytes: the ceiling now concerns only
the Mish sites left outside that pass (those without BN, int8 sites,
inputs the kernel does not take). Prints one JSON line last. With
``--device cpu`` the times are the host's (plumbing only).
"""

from __future__ import annotations

import argparse
import copy
import json
from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from yolov4_tpu_torch.config import Config, load_config
from yolov4_tpu_torch.engine.predictor import Predictor
from yolov4_tpu_torch.models.layers import (ACTIVATIONS, ConvBNAct,
                                            CSPDownSample, CSPDownSample0,
                                            quant_entries, quant_scope)
from yolov4_tpu_torch.tools.check_csp_fused import window_ms

ITERS = 20


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--size", type=int, default=608)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--quant", choices=["none", "int8", "int8_static"],
                   default="none")
    p.add_argument("--windows", type=int, default=6)
    p.add_argument("--pallas-csp", action="store_true",
                   help="MODEL.PALLAS_CSP: stages 1-3 keep Mish in K2")
    p.add_argument("--device", default="cuda")
    return p


def mish_sites(model: nn.Module) -> Dict[str, ConvBNAct]:
    """Every ConvBNAct of ``model`` that computes Mish."""
    return {name: m for name, m in model.named_modules()
            if isinstance(m, ConvBNAct) and m.act is ACTIVATIONS["mish"]}


def k2_sites(model: nn.Module) -> set:
    """The ConvBNActs whose work K2 does in an eval forward: the bodies of
    the CSP stages that fuse."""
    return {id(conv) for m in model.modules()
            if isinstance(m, (CSPDownSample0, CSPDownSample)) and m.fuses()
            for conv in m.foldable().values()}


def leaky_copy(model: nn.Module):
    """(copy, swapped, kept): a deep copy of ``model`` in which every Mish
    site outside K2 computes leaky ReLU 0.1; the names of the swapped
    sites and of the Mish sites K2 keeps."""
    leaky = copy.deepcopy(model)
    in_k2 = k2_sites(leaky)
    swapped, kept = [], []
    for name, m in mish_sites(leaky).items():
        if id(m) in in_k2:
            kept.append(name)
        else:
            m.act = ACTIVATIONS["leaky_relu"]
            swapped.append(name)
    return leaky, swapped, kept


def build_cfg(args: argparse.Namespace, cfg: Optional[Config] = None
              ) -> Config:
    cfg = load_config(None) if cfg is None else cfg
    cfg["MODEL"]["QUANT"] = args.quant
    cfg["MODEL"]["PALLAS_CSP"] = args.pallas_csp
    return cfg


def run(cfg: Config, args: argparse.Namespace) -> Dict:
    size, batch = args.size, args.batch
    pred = Predictor(cfg, img_size=size, batch_size=batch,
                     device=args.device)
    device, shipped = pred.device, pred.model
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.random((batch, 3, size, size),
                                    dtype=np.float32)).to(device)
    x = x.contiguous(memory_format=torch.channels_last)
    state = None
    if pred.quant == "int8_static":
        pred.calibrate((x.permute(0, 2, 3, 1) * 255).round().byte()
                       .cpu().numpy())
        state = quant_entries(shipped, pred.quant_state)
    leaky, swapped, kept = leaky_copy(shipped)

    def timed(model, iters):
        with torch.inference_mode(), quant_scope(state):
            return window_ms(model, x, iters, device)

    timed(shipped, 3)
    timed(leaky, 3)
    t_mish, t_leaky = [], []
    for _ in range(args.windows):
        t_mish.append(timed(shipped, ITERS))
        t_leaky.append(timed(leaky, ITERS))
    ratios = [b / a for a, b in zip(t_mish, t_leaky)]
    result = {
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "size": size, "batch": batch, "quant": args.quant,
        "dtype": cfg["MODEL"]["COMPUTE_DTYPE"],
        "pallas_csp": args.pallas_csp, "iters": ITERS,
        "timer": "cuda events" if device.type == "cuda" else "host",
        "mish_sites": len(swapped) + len(kept), "swapped": len(swapped),
        "kept_in_k2": len(kept), "mish_ms": t_mish, "leaky_ms": t_leaky,
        "mish_median_ms": float(np.median(t_mish)),
        "leaky_median_ms": float(np.median(t_leaky)),
        "leaky_over_mish_median": float(np.median(ratios)),
    }
    result["ceiling_ms"] = result["mish_median_ms"] - result["leaky_median_ms"]
    print(f"fwd+decode {size}/b{batch} quant={args.quant} PALLAS_CSP "
          f"{args.pallas_csp}: {len(swapped)} Mish sites swapped, "
          f"{len(kept)} kept in K2")
    print(f"  mish  windows ms: {[round(v, 3) for v in t_mish]}")
    print(f"  leaky windows ms: {[round(v, 3) for v in t_leaky]}")
    print(f"  leaky/mish median {result['leaky_over_mish_median']:.3f}x — "
          f"mish ceiling {result['ceiling_ms']:.3f} ms/batch")
    print(json.dumps(result))
    return result


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    args = build_parser().parse_args(argv)
    return run(build_cfg(args), args)


if __name__ == "__main__":
    main()
