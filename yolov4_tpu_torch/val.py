"""COCO val2017 evaluation CLI on the port (the root val.py's surface).

Usage:
    python -m yolov4_tpu_torch.val COCO [-c configs/yolov4_Tianxiaomo.cfg] \
        [--checkpoint weights.pth.tar] [--conf-thre 0.001] [--nms-thre 0.4] \
        [--batch-size 16] [--pre-nms-topk 2048] [--max-dets 100] \
        [--cat-cap 100] [--letterbox] [--device cuda]

COCO is a directory with ``annotations/instances_val2017.json`` and
``images/val2017/{id:012}.jpg``. Runs on CUDA unless ``--device`` names
another device; a missing card is an error. Weights are a JAX package
``.ckpt``, reference ``.pth``/``.pth.tar``/``.pt`` or ``.npz`` state
dicts; without one the weights are the reference init from seed 0. ``MODEL.PALLAS_CSP`` in the
config runs CSP stages 1-3 through the fused stage kernel.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence, Tuple

from yolov4_tpu_torch.config import load_config
from yolov4_tpu_torch.data.coco import COCODataset
from yolov4_tpu_torch.data.pipeline import DataLoader
from yolov4_tpu_torch.data.transforms import Transform
from yolov4_tpu_torch.engine.evaluator import validate
from yolov4_tpu_torch.engine.predictor import Predictor
from yolov4_tpu_torch.utils.convert import load_weights
from yolov4_tpu_torch.utils.logging import get_logger, setup_logging


def parse_args(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser(description="YOLOv4 COCO evaluation "
                                                 "(PyTorch/CUDA).")
    parser.add_argument("data", metavar="DIR", help="path to COCO dataset root")
    parser.add_argument("-c", "--cfg", type=str, default=None,
                        help="YAML config (default: built-in defaults)")
    parser.add_argument("-ckpt", "--checkpoint", type=str, default=None,
                        help="weights (.ckpt / .pth / .pth.tar / .pt / "
                             ".npz)")
    parser.add_argument("--conf-thre", type=float, default=-0.1)
    parser.add_argument("--nms-thre", type=float, default=-0.1)
    parser.add_argument("--batch-size", type=int, default=-1,
                        help="eval batch size (default cfg TEST.BATCH_SIZE)")
    parser.add_argument("--pre-nms-topk", type=int, default=-1,
                        help="candidate cap before NMS (default cfg "
                             "TEST.PRE_NMS_TOPK)")
    parser.add_argument("--max-dets", type=int, default=-1,
                        help="fixed detections per image (default cfg "
                             "TEST.MAX_DETS; use 1024 with --cat-cap 100 to "
                             "match pycocotools' per-category cap exactly)")
    parser.add_argument("--cat-cap", type=int, default=-1,
                        help="per-(image,category) scoring cap (default cfg "
                             "TEST.CAT_CAP=100; 0 disables)")
    parser.add_argument("--letterbox", action="store_true",
                        help="aspect-preserving letterbox eval geometry "
                             "(cfg TEST.LETTERBOX)")
    parser.add_argument("--device", type=str, default="cuda")
    return parser.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Tuple[float, float]:
    """Evaluate; returns (AP[.50:.95], AP50)."""
    args = parse_args(argv)
    setup_logging()
    logger = get_logger(__name__)
    cfg = load_config(args.cfg)
    test = cfg["TEST"]
    conf = test["CONFTHRE"] if args.conf_thre < 0 else args.conf_thre
    nms = test["NMSTHRE"] if args.nms_thre < 0 else args.nms_thre
    if args.pre_nms_topk > 0:
        test["PRE_NMS_TOPK"] = args.pre_nms_topk
    if args.max_dets > 0:
        test["MAX_DETS"] = args.max_dets
    if args.cat_cap >= 0:
        test["CAT_CAP"] = args.cat_cap
    if args.letterbox:
        test["LETTERBOX"] = True
    batch_size = (test.get("BATCH_SIZE", 8) if args.batch_size < 0
                  else args.batch_size)

    state_dict = None
    if args.checkpoint:
        state_dict = load_weights(args.checkpoint)
        logger.info(f"loaded weights {args.checkpoint}")
    else:
        logger.warning("no --checkpoint given: evaluating the seed-0 random "
                       "init")

    dataset = COCODataset(args.data, img_size=test["IMGSIZE"],
                          transform=Transform(cfg, keep_uint8=True),
                          num_classes=cfg["MODEL"]["N_CLASSES"])
    loader = DataLoader(dataset, batch_size=batch_size)
    logger.info(f"val2017: {len(dataset)} images, batch {batch_size}, imgsize "
                f"{test['IMGSIZE']}, conf {conf}, nms {nms}, device "
                f"{args.device}, PALLAS_CSP {cfg['MODEL']['PALLAS_CSP']}")
    predictor = Predictor(cfg, state_dict=state_dict, batch_size=batch_size,
                          conf_thre=conf, nms_thre=nms, device=args.device)
    ap, ap50 = validate(loader, predictor)
    logger.info(f"AP[.50:.95] = {ap:.5f}  AP50 = {ap50:.5f}")
    return ap, ap50


if __name__ == "__main__":
    main()
