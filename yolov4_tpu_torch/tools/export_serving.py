"""Export the serving program as one self-contained artifact file.

    python -m yolov4_tpu_torch.tools.export_serving out.y4t \
        [--ckpt model_best.ckpt] [--cfg configs/yolov4_Tianxiaomo.cfg] \
        [--img-size 608] [--batch-size 16] [--wire-dtype uint8] \
        [--device cuda] [--selfcheck]

The port's counterpart of the JAX package's tools/export_serving.py:
the weights (a JAX package ``.ckpt``, a reference ``.pth.tar`` or an
``.npz``) and the thresholds are baked into a ``torch.export`` program
covering wire bytes -> forward -> decode -> NMS (utils/export.py);
serving needs the file and this package's ops only. ``--selfcheck``
reloads the file and holds its output bit-identical to the live
predictor's on a random batch. The artifact runs on the device type it
was exported on (CUDA unless ``--device`` says otherwise). ``--quant``
other than ``none`` is refused: int8 is not ported.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np
import torch


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("output")
    p.add_argument("--cfg", default=None,
                   help="YAML config (default: built-in defaults)")
    p.add_argument("--ckpt", default=None)
    p.add_argument("--img-size", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--conf-thre", type=float, default=-1)
    p.add_argument("--nms-thre", type=float, default=-1)
    p.add_argument("--quant", choices=("none", "int8", "int8_static"),
                   default=None)
    p.add_argument("--wire-dtype", choices=("uint8", "float32"),
                   default="uint8")
    p.add_argument("--device", default="cuda")
    p.add_argument("--selfcheck", action="store_true",
                   help="reload the artifact and verify bit-identical "
                        "output vs the live predictor on a random batch")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Export; returns the header."""
    args = parse_args(argv)
    from yolov4_tpu_torch.config import load_config
    from yolov4_tpu_torch.engine.predictor import Predictor, pack_wire
    from yolov4_tpu_torch.utils.convert import load_weights
    from yolov4_tpu_torch.utils.export import export_serving, load_serving

    cfg = load_config(args.cfg)
    if args.quant is not None:
        cfg["MODEL"]["QUANT"] = args.quant   # build_model refuses int8
    conf = cfg["TEST"]["CONFTHRE"] if args.conf_thre < 0 else args.conf_thre
    nms = cfg["TEST"]["NMSTHRE"] if args.nms_thre < 0 else args.nms_thre
    size = args.img_size or cfg["TEST"]["IMGSIZE"]
    state_dict = None
    if args.ckpt:
        state_dict = load_weights(args.ckpt)
        print(f"loaded {args.ckpt}")
    else:
        print("WARNING: no --ckpt: exporting the seed-0 random init "
              "(plumbing check only)")
    predictor = Predictor(cfg, state_dict=state_dict, img_size=size,
                          batch_size=args.batch_size, conf_thre=conf,
                          nms_thre=nms, device=args.device)
    wire_dtype = np.dtype(args.wire_dtype)
    header = export_serving(predictor, args.output, wire_dtype=wire_dtype)
    mb = os.path.getsize(args.output) / 1e6
    print(f"exported {args.output} ({mb:.1f} MB): {header}")

    if args.selfcheck:
        art = load_serving(args.output, device=args.device)
        rng = np.random.default_rng(0)
        imgs = (rng.integers(0, 256, (2, size, size, 3), np.uint8)
                if wire_dtype == np.uint8 else
                rng.random((2, size, size, 3), np.float32))
        got = art.predict(imgs)
        flat = torch.from_numpy(pack_wire(imgs, args.batch_size))
        want = predictor.run_wire(flat.to(predictor.device))
        for g, w, name in zip(got, want, header["outputs"]):
            w = w.cpu().numpy()[:imgs.shape[0]]
            if g.shape != w.shape or not np.array_equal(g, w):
                raise SystemExit(f"selfcheck FAILED: {name} differs from "
                                 f"the live predictor's")
        print(f"selfcheck OK: artifact output bit-identical "
              f"({header['outputs']})")
    return header


if __name__ == "__main__":
    main()
