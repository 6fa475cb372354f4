"""Training CLI on the port (the root train.py's surface, reference
main_amp.py).

Usage:
    python -m yolov4_tpu_torch.train COCO -c configs/yolov4_Tianxiaomo.cfg \
        [--resume outputs/.../checkpoint.pth] [-e] [--print-freq 10] \
        [--profile N] [--opt-level O0|O1|O2|O3] [--sync_bn] \
        [--deterministic] [--seed 0] [--device cuda]

    torchrun --nproc_per_node N -m yolov4_tpu_torch.train COCO -c CFG ...
    torchrun --nnodes M --node_rank R --nproc_per_node N \
        -m yolov4_tpu_torch.train COCO -c CFG --coordinator HOST:PORT ...

COCO is a directory with ``annotations/instances_{train,val}2017.json``
and ``images/{train,val}2017/{id:012}.jpg``. Runs on CUDA unless
``--device`` names another device; a missing card is an error. Against
the reference (main_amp.py:34-58):
  * data parallel as the reference (one process per GPU, NCCL): under
    torchrun rank r trains on cuda:{LOCAL_RANK} with DATA.BATCH_SIZE
    images a step from its shard of the data, gradients, BN statistics
    and the loss averaged over the ranks (per-replica BN); without
    torchrun, one process on one device. ``--coordinator`` names the
    rendezvous of a multi-node run (MASTER_ADDR:MASTER_PORT). Only rank 0
    logs and writes files;
  * --opt-level maps apex AMP levels onto the compute dtype: O0 ->
    float32, O1/O2/O3 -> bfloat16 under torch.autocast with float32
    weights (bfloat16 needs no loss scaling);
  * --sync_bn is accepted and not applied, as in the reference's YOLO
    path (per-replica BN);
  * resume restores the optimizer and the schedule's step for real;
  * the log goes to stdout and, once the config is read, to
    ``OUTPUT_DIR/stdout.log`` as well;
  * ``AUGMENTATION.DEVICE: true`` augments on the card inside the train
    step (data/device_aug.py); the loader then decodes and resizes only.
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
                        help="torch device (default cuda: cuda:LOCAL_RANK "
                             "under torchrun; a missing card is an error)")
    parser.add_argument("--coordinator", type=str, default=None,
                        metavar="HOST:PORT",
                        help="rendezvous address of a multi-node run "
                             "(sets MASTER_ADDR / MASTER_PORT)")
    return parser.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None):
    args = parse_args(argv)

    import torch.distributed as tdist

    from yolov4_tpu_torch.engine.predictor import resolve_device
    from yolov4_tpu_torch.parallel import dist as dist_lib

    try:
        device = resolve_device(args.device)
    except RuntimeError as err:
        raise SystemExit(f"error: {err}") from None
    # a group this call starts, it also ends
    joined = (not tdist.is_initialized()
              and dist_lib.init_distributed(args.coordinator, device=device))
    try:
        return _train(args, dist_lib.device_for_rank(device))
    finally:
        if joined:
            dist_lib.shutdown()


def _train(args, device):
    from yolov4_tpu_torch.config import load_config
    from yolov4_tpu_torch.engine.trainer import Trainer
    from yolov4_tpu_torch.parallel import dist as dist_lib
    from yolov4_tpu_torch.utils.logging import get_logger, setup_logging

    setup_logging(process_index=dist_lib.rank())
    logger = get_logger(__name__)
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
    # again with the output directory, now that the config names it
    setup_logging(process_index=dist_lib.rank(),
                  output_dir=cfg["TRAIN"]["OUTPUT_DIR"])
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
