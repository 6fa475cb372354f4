"""Training CLI on the port (the root train.py's surface, reference
main_amp.py).

Usage:
    python -m yolov4_tpu_torch.train COCO -c configs/yolov4_Tianxiaomo.cfg \
        [--resume outputs/.../checkpoint.pth] [-e] [--print-freq 10] \
        [--profile N] [--opt-level O0|O1|O2|O3] [--sync_bn] \
        [--deterministic] [--seed 0] [--device cuda]

COCO is a directory with ``annotations/instances_{train,val}2017.json``
and ``images/{train,val}2017/{id:012}.jpg``. Runs on CUDA unless
``--device`` names another device; a missing card is an error. Against
the reference (main_amp.py:34-58):
  * one process on one device (data parallelism is not ported yet);
  * --opt-level maps apex AMP levels onto the compute dtype: O0 ->
    float32, O1/O2/O3 -> bfloat16 under torch.autocast with float32
    weights (bfloat16 needs no loss scaling);
  * --sync_bn is accepted and not applied, as in the reference's YOLO
    path (per-replica BN);
  * resume restores the optimizer and the schedule's step for real.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence


def parse_args(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser(description="YOLOv4 training "
                                                 "(PyTorch/CUDA).")
    parser.add_argument("data", metavar="DIR", help="path to COCO dataset root")
    parser.add_argument("-c", "--cfg", type=str,
                        default="configs/yolov4_default.cfg")
    parser.add_argument("--resume", type=str, default=None,
                        help="checkpoint.pth to resume from")
    parser.add_argument("-e", "--evaluate", action="store_true",
                        help="evaluate on val2017 and exit")
    parser.add_argument("--print-freq", type=int, default=10)
    parser.add_argument("--profile", type=int, default=0, metavar="N",
                        help="trace N steps with torch.profiler into "
                             "OUTPUT_DIR/profile")
    parser.add_argument("--opt-level", type=str, default=None,
                        choices=["O0", "O1", "O2", "O3"],
                        help="apex-style precision: O0=float32, O1+=bfloat16")
    parser.add_argument("--sync_bn", action="store_true",
                        help="accepted for parity; not applied (per-replica BN)")
    parser.add_argument("--deterministic", action="store_true")
    parser.add_argument("--channels-last",
                        action=argparse.BooleanOptionalAction, default=True,
                        help="channels-last activations on the card "
                             "(disable with --no-channels-last)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default cuda; a missing card "
                             "is an error)")
    return parser.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None):
    args = parse_args(argv)

    from yolov4_tpu_torch.config import load_config
    from yolov4_tpu_torch.engine.predictor import resolve_device
    from yolov4_tpu_torch.engine.trainer import Trainer
    from yolov4_tpu_torch.utils.logging import get_logger, setup_logging

    setup_logging()
    logger = get_logger(__name__)
    try:
        device = resolve_device(args.device)
    except RuntimeError as err:
        raise SystemExit(f"error: {err}") from None
    cfg = load_config(args.cfg)
    if args.opt_level is not None:
        cfg["MODEL"]["COMPUTE_DTYPE"] = (
            "float32" if args.opt_level == "O0" else "bfloat16")
    if args.sync_bn:
        logger.warning("--sync_bn requested: not applied (per-replica BN, "
                       "matching the reference YOLO trainer)")
    if args.deterministic:
        # host randomness (shuffle, augmentation) is already seed-derived;
        # this pins the base seeds like the reference's torch.manual_seed
        # (main_amp.py:81-85) and asks for deterministic cuDNN kernels
        import random

        import numpy as np
        import torch
        random.seed(args.seed)
        np.random.seed(args.seed)
        torch.manual_seed(args.seed)
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        logger.info(f"deterministic mode: base seed {args.seed}")
    logger.info(f"config: {args.cfg}, compute {cfg['MODEL']['COMPUTE_DTYPE']}, "
                f"device {device}")

    trainer = Trainer(cfg, args.data, resume=args.resume,
                      print_freq=args.print_freq, seed=args.seed,
                      profile_steps=args.profile,
                      evaluate_only=args.evaluate, device=device,
                      channels_last=args.channels_last)
    return trainer.fit(evaluate_only=args.evaluate)


if __name__ == "__main__":
    main()
