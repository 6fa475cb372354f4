"""CSPDarknet53 ImageNet pretraining CLI on the port (the root
darknet_pretrain.py's surface, reference darknet/main_amp.py).

Usage:
    python -m yolov4_tpu_torch.darknet_pretrain ./imagenet/ -b 128 \
        --lr 0.1 --epochs 120 [--resume CKPT] [-e] [--opt-level O1] \
        [--sync_bn] [--device cuda]

    torchrun --nproc_per_node N -m yolov4_tpu_torch.darknet_pretrain DIR ...

DIR holds ``train/<class>/*.jpg`` and ``val/<class>/*.jpg``. Runs on CUDA
unless ``--device`` names another device; a missing card is an error.
Under torchrun each rank trains on cuda:{LOCAL_RANK} with ``-b`` images a
step (``--coordinator`` names a multi-node rendezvous); only rank 0 logs
and writes. ``--opt-level`` O0 trains in float32, O1/O2/O3 under bfloat16
autocast over float32 weights. ``--sync_bn`` normalizes with the
statistics of the batch over all ranks (a no-op with one). The log goes
to stdout and ``OUTPUT_DIR/stdout.log``. The best checkpoint
(``OUTPUT_DIR/model_best.pth``) plugs into detection training as
MODEL.BACKBONE_PRETRAINED.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence


def parse_args(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser(
        description="CSPDarknet53 ImageNet training (PyTorch/CUDA).")
    parser.add_argument("data", metavar="DIR",
                        help="dataset root with train/ and val/ subdirs")
    parser.add_argument("-b", "--batch-size", type=int, default=128,
                        help="per-rank batch size")
    parser.add_argument("--lr", "--learning-rate", type=float, default=0.1,
                        dest="lr", help="base LR, scaled by global_batch/256")
    parser.add_argument("--epochs", type=int, default=120)
    parser.add_argument("-j", "--workers", type=int, default=4)
    parser.add_argument("--crop-size", type=int, default=256)
    parser.add_argument("--val-size", type=int, default=288)
    parser.add_argument("--num-classes", type=int, default=1000)
    parser.add_argument("--resume", type=str, default=None,
                        help="checkpoint.pth, or the JAX package's "
                             "checkpoint.ckpt (its Adam state and schedule "
                             "position carried), to resume from; with -e, "
                             "any weights file")
    parser.add_argument("-e", "--evaluate", action="store_true")
    parser.add_argument("--print-freq", type=int, default=10)
    parser.add_argument("--opt-level", type=str, default="O1",
                        choices=["O0", "O1", "O2", "O3"],
                        help="apex-style precision: O0=float32, O1+=bfloat16")
    parser.add_argument("--sync_bn", action="store_true",
                        help="cross-rank BatchNorm statistics "
                             "(reference darknet/main_amp.py:147-150)")
    parser.add_argument("--output-dir", type=str,
                        default="./outputs/cspdarknet53")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--transfer-layout", type=str, default="s2d",
                        choices=["s2d", "planar", "nhwc"],
                        help="accepted for parity; the port uploads NHWC "
                             "uint8 batches")
    parser.add_argument("--prof", type=int, default=0, metavar="N",
                        help="trace N train steps from step 10 with "
                             "torch.profiler into OUTPUT_DIR/profile "
                             "(reference darknet/main_amp.py:350-427)")
    parser.add_argument("--checkpoint-every-steps", type=int, default=0,
                        metavar="N",
                        help="mid-epoch checkpoints: roll the full state "
                             "into checkpoint.pth every N steps; a resume "
                             "re-enters the epoch at the next batch (0 = "
                             "per-epoch saves only)")
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

    import torch
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
        from yolov4_tpu_torch.classify.trainer import ClassifierTrainer
        from yolov4_tpu_torch.utils.logging import get_logger, setup_logging

        setup_logging(process_index=dist_lib.rank(),
                      output_dir=args.output_dir)
        logger = get_logger(__name__)
        if args.transfer_layout != "nhwc":
            # the JAX package's flat wire avoids a TPU lane-padding cost
            # that a GPU upload does not have
            logger.info(f"--transfer-layout {args.transfer_layout}: no-op "
                        "(uint8 NHWC upload)")
        trainer = ClassifierTrainer(
            args.data, batch_size=args.batch_size, lr=args.lr,
            epochs=args.epochs, workers=args.workers,
            crop_size=args.crop_size, val_size=args.val_size,
            num_classes=args.num_classes, output_dir=args.output_dir,
            print_freq=args.print_freq, resume=args.resume,
            compute_dtype=(torch.float32 if args.opt_level == "O0"
                           else torch.bfloat16),
            seed=args.seed, sync_bn=args.sync_bn, profile_steps=args.prof,
            checkpoint_every_steps=args.checkpoint_every_steps,
            device=device, evaluate_only=args.evaluate)
        return trainer.fit(evaluate_only=args.evaluate)
    finally:
        if joined:
            dist_lib.shutdown()


if __name__ == "__main__":
    main()
