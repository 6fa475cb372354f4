"""Export the serving program as one self-contained artifact file.

    python -m yolov4_tpu_torch.tools.export_serving out.y4t \
        [--ckpt model_best.ckpt] [--cfg configs/yolov4_Tianxiaomo.cfg] \
        [--img-size 608] [--batch-size 16] [--wire-dtype uint8] \
        [--quant int8_static --calib-images DIR] [--device cuda] \
        [--selfcheck]

The port's counterpart of the JAX package's tools/export_serving.py:
the weights (a JAX package ``.ckpt``, a reference ``.pth.tar`` or an
``.npz``) and the thresholds are baked into a ``torch.export`` program
covering wire bytes -> forward -> decode -> NMS (utils/export.py);
serving needs the file and this package's ops only. ``--selfcheck``
reloads the file and holds its output bit-identical to the live
predictor's on a random batch. The artifact runs on the device type it
was exported on (CUDA unless ``--device`` says otherwise). ``--quant``
sets ``MODEL.QUANT``; an int8_static export calibrates first on up to
``--batch-size`` images of ``--calib-images`` (jpg/png, resized to the
export size; random uint8 images, with a warning, when there are none),
and the scales become constants of the program.
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
    p.add_argument("--calib-images", default=None,
                   help="directory of jpg/png for int8_static calibration")
    p.add_argument("--wire-dtype", choices=("uint8", "float32"),
                   default="uint8")
    p.add_argument("--device", default="cuda")
    p.add_argument("--selfcheck", action="store_true",
                   help="reload the artifact and verify bit-identical "
                        "output vs the live predictor on a random batch")
    return p.parse_args(argv)


def calibration_images(folder: Optional[str], n: int,
                       size: int) -> np.ndarray:
    """Up to ``n`` jpg/png images of ``folder`` as a uint8 RGB batch
    resized to ``size``; ``n`` seeded random images when there are none."""
    import glob

    import cv2
    paths = []
    if folder:
        for pat in ("*.jpg", "*.png"):
            paths += sorted(glob.glob(os.path.join(folder, pat)))
    loaded = []
    for f in paths[:n]:
        img = cv2.imread(f)
        if img is None:
            print(f"WARNING: skipping unreadable image {f}")
            continue
        loaded.append(cv2.resize(img[:, :, ::-1], (size, size)))
    if loaded:
        print(f"calibrating on {len(loaded)} image(s)")
        return np.stack(loaded).astype(np.uint8)
    print("WARNING: int8_static with no --calib-images: calibrating on "
          "random data")
    return np.random.default_rng(0).integers(0, 256, (n, size, size, 3),
                                             np.uint8)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Export; returns the header."""
    args = parse_args(argv)
    from yolov4_tpu_torch.config import load_config
    from yolov4_tpu_torch.engine.predictor import Predictor, pack_wire
    from yolov4_tpu_torch.utils.convert import load_weights
    from yolov4_tpu_torch.utils.export import export_serving, load_serving

    cfg = load_config(args.cfg)
    if args.quant is not None:
        cfg["MODEL"]["QUANT"] = args.quant
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
    if predictor.quant == "int8_static":
        predictor.calibrate(calibration_images(args.calib_images,
                                               args.batch_size, size))
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
