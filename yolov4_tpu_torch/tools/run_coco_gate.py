"""The 0.359-AP gate in one command; the port's copy of the JAX package's
tools/run_coco_gate.py.

    python -m yolov4_tpu_torch.tools.run_coco_gate [--data DIR]
        [--checkpoint PATH] [--cfg CFG] [--batch-size 8]
        [--conf-thre 0.0001] [--nms-thre 0.4] [--pre-nms-topk 2048]
        [--max-dets 1024] [--quant int8] [--device cuda]

Searches the usual places for COCO val2017 and trained weights (a
reference ``.pth.tar``, the port's ``model_best.pth`` or a JAX package
``.ckpt``). If both exist it runs the published eval protocol (conf
0.0001, NMS 0.4, 608x608 by the default cfg) through the port's
``val.main`` and prints AP and AP50 against the published 0.35925 /
0.59468, exiting 0 when AP is within 0.002 of it and 1 otherwise. If
either is missing it says exactly what and exits 2; it never downloads
anything.
"""

from __future__ import annotations

import argparse
import glob
import os
from typing import Optional, Sequence

PUBLISHED_AP = 0.35925
PUBLISHED_AP50 = 0.59468

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_CFG = os.path.join(REPO, "configs", "yolov4_Tianxiaomo.cfg")

DATA_CANDIDATES = [
    "./COCO", "./data/COCO", "~/COCO", "~/data/COCO", "/data/COCO",
    "/datasets/COCO", "~/datasets/COCO",
]
CKPT_CANDIDATES = [
    "./model_best.pth.tar", "./checkpoint.pth.tar",
    "./weights/model_best.pth.tar", "~/weights/model_best.pth.tar",
    "./outputs/yolov4/model_best.pth",
]


def find_data(explicit: Optional[str]) -> Optional[str]:
    """A root with annotations/instances_val2017.json and images/val2017
    (the layout COCODataset reads). A root in the stock layout (val2017/
    right under it) gets a remediation hint instead: the eval would fail
    on missing image paths."""
    roots = [explicit] if explicit else []
    roots += [os.environ.get("COCO_ROOT", "")] + DATA_CANDIDATES
    for root in roots:
        if not root:
            continue
        root = os.path.expanduser(root)
        ann = os.path.join(root, "annotations", "instances_val2017.json")
        if not os.path.isfile(ann):
            continue
        if os.path.isdir(os.path.join(root, "images", "val2017")):
            return root
        if os.path.isdir(os.path.join(root, "val2017")):
            print(f"NOTE: {root} has val2017/ at the top level; "
                  f"COCODataset needs images/val2017 — create it, e.g.\n"
                  f"  mkdir -p {root}/images && "
                  f"ln -s {root}/val2017 {root}/images/val2017")
    return None


def find_ckpt(explicit: Optional[str]) -> Optional[str]:
    paths = [explicit] if explicit else []
    paths += [os.environ.get("YOLOV4_CKPT", "")] + CKPT_CANDIDATES
    paths += sorted(glob.glob("./**/model_best.pth.tar", recursive=True))[:5]
    for p in paths:
        if p and os.path.isfile(os.path.expanduser(p)):
            return os.path.expanduser(p)
    return None


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--data", default=None)
    parser.add_argument("--checkpoint", default=None)
    parser.add_argument("--cfg", default=DEFAULT_CFG)
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--conf-thre", type=float, default=0.0001)
    parser.add_argument("--nms-thre", type=float, default=0.4)
    parser.add_argument("--pre-nms-topk", type=int, default=2048,
                        help="AP-identical to 8192 at these settings")
    parser.add_argument("--max-dets", type=int, default=1024,
                        help="with TEST.CAT_CAP=100 (default), rows that "
                             "cannot affect pycocotools' per-(image, "
                             "category) top-100 scoring are dropped first, "
                             "so 1024 equals the reference's unlimited rows "
                             "whenever <= 1024 relevant rows exist an image "
                             "(the eval logs an overflow otherwise)")
    parser.add_argument("--quant", choices=("none", "int8", "int8_static"),
                        default=None,
                        help="measure the int8 serving AP delta against the "
                             "bf16 gate run (int8 is not reference-exact; "
                             "the gate target applies to the default path)")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    data = find_data(args.data)
    ckpt = find_ckpt(args.checkpoint)
    missing = []
    if data is None:
        missing.append("COCO val2017 (annotations/instances_val2017.json + "
                       "images/val2017) — searched ./COCO, ~/COCO, "
                       "$COCO_ROOT, ...")
    if ckpt is None:
        missing.append("trained weights (model_best.pth.tar, .pth or .ckpt) "
                       "— searched ./, ./weights, $YOLOV4_CKPT, ...")
    if missing:
        print("COCO gate BLOCKED; missing:")
        for m in missing:
            print(f"  - {m}")
        return 2

    print(f"data: {data}\ncheckpoint: {ckpt}")
    val_argv = [
        data, "-c", args.cfg, "--checkpoint", ckpt,
        "--conf-thre", str(args.conf_thre), "--nms-thre", str(args.nms_thre),
        "--batch-size", str(args.batch_size),
        "--pre-nms-topk", str(args.pre_nms_topk),
        "--max-dets", str(args.max_dets), "--device", args.device,
    ]
    if args.quant is not None:
        val_argv += ["--quant", args.quant]
    from yolov4_tpu_torch import val
    ap, ap50 = val.main(val_argv)
    print(f"\nGATE: AP {ap:.5f} (published {PUBLISHED_AP}) "
          f"AP50 {ap50:.5f} (published {PUBLISHED_AP50})")
    ok = ap >= PUBLISHED_AP - 0.002
    print("GATE " + ("PASSED" if ok else "NOT met"))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
