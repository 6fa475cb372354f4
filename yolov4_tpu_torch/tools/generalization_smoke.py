"""Generalization smoke: train on synthetic detectable shapes, score a
HELD-OUT split; the port's copy of the JAX package's
tools/generalization_smoke.py.

    python -m yolov4_tpu_torch.tools.generalization_smoke [--epochs 40]
        [--img-size 320] [--batch-size 8] [--train-images 128]
        [--val-images 32] [--root DIR] [--assert-ap50 X] [--use-trainer
        [--device-aug] [--recipe] [--resume CKPT]] [--quant-eval]
        [--seed N] [--hard] [--box-loss ciou] [--ema 0.99]
        [--multiscale 288,320,352] [--letterbox] [--width W] [--depth D]
        [--device cuda]

Stronger evidence than tools/overfit_smoke.py (one fixed batch driven to
memorization): the annotations are drawn objects (rectangle / circle /
triangle, three classes; six with ``--hard``, data/synthetic.py
``make_shapes_coco``), the training split goes through the real loader
(shuffled, fresh batches every epoch) and AP is measured on images the
model has never seen, through the Predictor (K1, and K2 under
MODEL.PALLAS_CSP, on a card). ``--use-trainer`` drives
``engine/trainer.Trainer`` instead of the manual loop: the reference's
augmentation, per-epoch held-out evaluation, best-AP50 checkpoints;
``--recipe`` adds the reference schedule scaled to the smoke and prints
the AP curve. ``--quant-eval`` scores the held-out split through the
int8 / int8_static / approx-topk serving presets against the same raw
training weights.

The dataset is regenerated when ``ROOT/dataset_params.json`` does not
match the flags; under ``--resume`` a mismatch is an error instead (the
root holds the checkpoint being resumed), and ``--resume`` needs
``--use-trainer``. ``run(cfg, args)`` is the smoke without the CLI: it
returns the losses, APs, times, K1/K2 launches and the trained weights.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import shutil
import tempfile
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from yolov4_tpu_torch.config import Config, load_config
from yolov4_tpu_torch.data.coco import COCODataset
from yolov4_tpu_torch.data.pipeline import DataLoader
from yolov4_tpu_torch.data.synthetic import make_shapes_coco
from yolov4_tpu_torch.data.transforms import Transform
from yolov4_tpu_torch.engine.evaluator import validate
from yolov4_tpu_torch.engine.predictor import Predictor, resolve_device
from yolov4_tpu_torch.ops import kernel_launches, launches_since
from yolov4_tpu_torch.tools.overfit_smoke import (CONF, NMS, build_train,
                                                  eval_loader, score, sync,
                                                  to_device)

QUANT_PRESETS = (
    ("int8/late", {"QUANT": "int8", "QUANT_SPAN": "late"}, {}),
    ("int8/full", {"QUANT": "int8", "QUANT_SPAN": "full"}, {}),
    ("int8_static/late", {"QUANT": "int8_static", "QUANT_SPAN": "late"}, {}),
    ("int8_static/full", {"QUANT": "int8_static", "QUANT_SPAN": "full"}, {}),
    ("approx_topk", {}, {"APPROX_TOPK": True}))


class DatasetMismatch(ValueError):
    """--resume over a root whose dataset the flags do not describe."""


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--epochs", type=int, default=40)
    parser.add_argument("--img-size", type=int, default=320)
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--train-images", type=int, default=128)
    parser.add_argument("--val-images", type=int, default=32)
    parser.add_argument("--root", default=os.path.join(
        tempfile.gettempdir(), "coco_shapes"))
    parser.add_argument("--assert-ap50", type=float, default=-1.0,
                        help="fail below this held-out AP50 (<0 = report only)")
    parser.add_argument("--use-trainer", action="store_true",
                        help="drive engine.Trainer instead of the manual "
                             "loop: reference augmentation (mosaic/flip/"
                             "HSV), per-epoch held-out eval, best-AP50 "
                             "checkpointing")
    parser.add_argument("--device-aug", action="store_true",
                        help="with --use-trainer: run the augmentation on "
                             "the device (AUGMENTATION.DEVICE)")
    parser.add_argument("--recipe", action="store_true",
                        help="with --use-trainer: the reference training "
                             "recipe scaled to the smoke (per-iteration "
                             "warmup of 2 epochs, Adam, MultiStep "
                             "milestones at [2/3, 5/6] of the epochs, gamma "
                             "0.1, accumulation 2); prints the held-out AP "
                             "curve and whether the LR drop helped")
    parser.add_argument("--quant-eval", action="store_true",
                        help="after training, score the held-out split "
                             "through the int8 / int8_static / approx-topk "
                             "serving presets and report AP deltas against "
                             "the bf16 eval of the same weights")
    parser.add_argument("--resume", default=None,
                        help="with --use-trainer: resume a killed smoke "
                             "run from its checkpoint.pth (same flags, same "
                             "OUTPUT_DIR; metrics.jsonl spans both runs)")
    parser.add_argument("--seed", type=int, default=0,
                        help="the Trainer's init/loader/aug seed (the "
                             "manual loop keeps seed 0, as the JAX tool)")
    parser.add_argument("--hard", action="store_true",
                        help="harder dataset: 6 classes (incl. a hollow "
                             "ring), up to 8 overlapping shapes an image, "
                             "log-uniform scales ~min/40..min/4")
    parser.add_argument("--box-loss", default=None,
                        choices=("mse", "iou", "giou", "diou", "ciou"),
                        help="CRITERION.BOX_LOSS for this run")
    parser.add_argument("--ema", type=float, default=None,
                        help="TRAIN.EMA_DECAY for this run (e.g. 0.99)")
    parser.add_argument("--multiscale", default=None,
                        help="comma-separated TRAIN.MULTISCALE sizes, "
                             "e.g. 288,320,352")
    parser.add_argument("--letterbox", action="store_true",
                        help="TEST.LETTERBOX eval geometry")
    parser.add_argument("--width", type=float, default=1.0,
                        help="MODEL.WIDTH (reduced variants for CPU "
                             "plumbing checks; recorded runs use 1.0)")
    parser.add_argument("--depth", type=float, default=1.0)
    parser.add_argument("--device", default="cuda")
    return parser


def dataset_stamp(args: argparse.Namespace) -> Dict:
    return {"train_images": args.train_images, "val_images": args.val_images,
            "img_size": args.img_size, "hard": bool(args.hard)}


def prepare_dataset(args: argparse.Namespace) -> None:
    """Regenerate the root when its stamp does not describe the flags (a
    stale root would silently train on other data). Under ``--resume`` a
    mismatch raises DatasetMismatch before anything is deleted: the root
    holds the checkpoint being resumed."""
    stamp_path = os.path.join(args.root, "dataset_params.json")
    stamp = dataset_stamp(args)
    on_disk = None
    if os.path.isfile(stamp_path):
        with open(stamp_path) as f:
            on_disk = json.load(f)
    if on_disk == stamp:
        return
    if args.resume:
        raise DatasetMismatch(
            f"--resume: {args.root} holds the dataset {on_disk}, the flags "
            f"ask for {stamp}; regenerating it would delete the checkpoint "
            "being resumed. Resume with the flags of the run that wrote it.")
    if os.path.isdir(args.root):
        shutil.rmtree(args.root)
    # disjoint seeds give disjoint layouts: the val images are unseen; the
    # dataset seeds stay fixed, --seed varies the training only
    S = args.img_size
    make_shapes_coco(args.root, "train2017", n_images=args.train_images,
                     seed=100, img_hw=(S, S), id_base=1000, hard=args.hard)
    make_shapes_coco(args.root, "val2017", n_images=args.val_images,
                     seed=999, img_hw=(S, S), id_base=90000, hard=args.hard)
    with open(stamp_path, "w") as f:
        json.dump(stamp, f)


def knob_desc(args: argparse.Namespace) -> List[str]:
    desc = []
    if args.box_loss is not None:
        desc.append(f"box_loss={args.box_loss}")
    if args.ema is not None:
        desc.append(f"ema={args.ema}")
    if args.multiscale is not None:
        desc.append(f"multiscale={multiscale_sizes(args)}")
    if args.letterbox:
        desc.append("letterbox")
    if args.hard:
        desc.append("hard")
    if args.seed:
        desc.append(f"seed={args.seed}")
    return desc


def multiscale_sizes(args: argparse.Namespace) -> List[int]:
    return [int(s) for s in args.multiscale.split(",") if s]


def recipe_milestones(epochs: int) -> List[int]:
    """The reference's 90 / [50, 70, 80] milestones scaled to the smoke."""
    return sorted({max(2, round(epochs * 2 / 3)),
                   max(3, round(epochs * 5 / 6))})


def output_dir(args: argparse.Namespace) -> str:
    desc = knob_desc(args)
    tag = "out" + ("_" + "_".join(
        d.replace("=", "").replace("[", "").replace("]", "")
        .replace(", ", "-").replace(" ", "") for d in desc) if desc else "")
    if args.device_aug:
        tag += "_devaug"
    return os.path.join(args.root, tag)


def build_cfg(args: argparse.Namespace) -> Config:
    """The JAX tool's config, the Trainer's settings included with
    ``--use-trainer``."""
    S, B = args.img_size, args.batch_size
    cfg = load_config()
    if args.width != 1.0 or args.depth != 1.0:
        cfg["MODEL"].update(WIDTH=args.width, DEPTH=args.depth)
    cfg["TRAIN"]["IMGSIZE"] = S
    cfg["TEST"].update(IMGSIZE=S, BATCH_SIZE=B, CONFTHRE=CONF, NMSTHRE=NMS)
    # light, label-preserving augmentation: flips on (shapes stay valid),
    # mosaic and colour off
    cfg["AUGMENTATION"].update(IS_MOSAIC=False, COLOR_DITHERING=False,
                               RANDOM_HORIZONTAL_FLIP=True, JITTER=0.0)
    cfg["OPTIMIZER"]["LR"] = 1e-3
    cfg["LR_SCHEDULER"].update(IS_WARMUP=True, WARMUP_EPOCH=1)
    if args.box_loss is not None:
        cfg["CRITERION"]["BOX_LOSS"] = args.box_loss
    if args.ema is not None:
        cfg["TRAIN"]["EMA_DECAY"] = args.ema
    if args.multiscale is not None:
        cfg["TRAIN"]["MULTISCALE"] = multiscale_sizes(args)
    if args.letterbox:
        cfg["TEST"]["LETTERBOX"] = True
    if args.use_trainer:
        # the production path: the reference's mosaic/crop/flip/HSV (host,
        # or on the device with --device-aug)
        cfg["AUGMENTATION"].update(IS_MOSAIC=True, COLOR_DITHERING=True,
                                   JITTER=0.3, DEVICE=bool(args.device_aug))
        cfg["TRAIN"].update(MAX_EPOCHS=args.epochs,
                            OUTPUT_DIR=output_dir(args))
        cfg["DATA"].update(WORKERS=0, BATCH_SIZE=B)
        if args.recipe:
            cfg["LR_SCHEDULER"].update(
                TYPE="MultiStepLR", MILESTONES=recipe_milestones(args.epochs),
                GAMMA=0.1, IS_WARMUP=True, WARMUP_EPOCH=2)
            cfg["TRAIN"]["ACCUMULATION_STEPS"] = 2
    return cfg


def train_loader(cfg: Config, args: argparse.Namespace) -> DataLoader:
    """The manual loop's loader: train2017 shuffled, seed 0."""
    ds = COCODataset(args.root, img_size=args.img_size, name="train2017",
                     is_train=True,
                     transform=Transform(cfg, is_train=True, seed=0), seed=0)
    return DataLoader(ds, batch_size=args.batch_size, shuffle=True, seed=0)


def report_recipe_curve(out_dir: str, milestones: List[int]) -> Dict:
    """Print the per-epoch held-out AP curve from metrics.jsonl and whether
    the LR drop at the first milestone helped: the mean AP50 of the epochs
    after it against the 3 epochs up to it."""
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    curve = [(r["epoch"], r["ap"], r["ap50"]) for r in records
             if r.get("kind") == "eval"]
    print("held-out AP curve (epoch, AP, AP50):")
    for e, ap, ap50 in curve:
        mark = " <- milestone" if e - 1 in milestones else ""
        print(f"  {e:3d}  {ap:.3f}  {ap50:.3f}{mark}")
    m0 = milestones[0]
    pre = [ap50 for e, _, ap50 in curve if m0 - 3 < e <= m0]
    post = [ap50 for e, _, ap50 in curve if e > m0]
    out = {"curve": curve, "pre_ap50": None, "post_ap50": None}
    if pre and post:
        out.update(pre_ap50=float(np.mean(pre)), post_ap50=float(np.mean(post)))
        print(f"post-milestone LR drop: mean AP50 {out['pre_ap50']:.3f} "
              f"(3 epochs pre) -> {out['post_ap50']:.3f} (post), delta "
              f"{out['post_ap50'] - out['pre_ap50']:+.4f}")
    return out


def quant_ab(cfg: Config, weights, root: str, img_size: int,
             batch_size: int, device) -> Dict:
    """Held-out accuracy of the serving presets against bf16 on the SAME
    weights: {preset: {ap, ap50, delta_ap, delta_ap50}}, "bf16" the
    baseline."""
    def preset_cfg(model_upd, test_upd):
        qcfg = copy.deepcopy(cfg)
        qcfg["MODEL"]["QUANT"] = "none"
        qcfg["TEST"]["APPROX_TOPK"] = False
        qcfg["MODEL"].update(model_upd)
        qcfg["TEST"].update(test_upd)
        return qcfg

    ap, ap50 = score(preset_cfg({}, {}), weights, root, "val2017", img_size,
                     batch_size, device)
    print(f"bf16 held-out (same params): AP {ap:.3f} AP50 {ap50:.3f}")
    out = {"bf16": {"ap": ap, "ap50": ap50, "delta_ap": 0.0,
                    "delta_ap50": 0.0}}
    for name, model_upd, test_upd in QUANT_PRESETS:
        qap, qap50 = score(preset_cfg(model_upd, test_upd), weights, root,
                           "val2017", img_size, batch_size, device)
        print(f"{name:18s} held-out: AP {qap:.3f} (delta {qap - ap:+.4f}) "
              f"AP50 {qap50:.3f} (delta {qap50 - ap50:+.4f})", flush=True)
        out[name] = {"ap": qap, "ap50": qap50, "delta_ap": qap - ap,
                     "delta_ap50": qap50 - ap50}
    return out


def run_trainer(cfg: Config, args: argparse.Namespace) -> Dict:
    from yolov4_tpu_torch.engine.trainer import Trainer
    t0 = time.time()
    trainer = Trainer(cfg, args.root, resume=args.resume, seed=args.seed,
                      device=args.device)
    best_ap, best_ap50 = trainer.fit()
    seconds = time.time() - t0
    desc = knob_desc(args)
    knobs = (" [" + ", ".join(desc) + "]") if desc else ""
    print(f"TRAINER mode ({'device' if args.device_aug else 'host'} "
          f"aug{', full recipe' if args.recipe else ''}){knobs}: "
          f"best held-out AP {best_ap:.3f} AP50 {best_ap50:.3f} "
          f"in {seconds:.0f}s", flush=True)
    result = {"mode": "trainer", "ap": best_ap, "ap50": best_ap50,
              "seconds": seconds, "output_dir": cfg["TRAIN"]["OUTPUT_DIR"],
              "steps": trainer.state.step,
              # the raw training weights, as the JAX tool's state.params
              "weights": trainer.model.state_dict()}
    if args.recipe:
        result["recipe"] = report_recipe_curve(
            cfg["TRAIN"]["OUTPUT_DIR"], recipe_milestones(args.epochs))
    return result


def run_manual(cfg: Config, args: argparse.Namespace) -> Dict:
    device = resolve_device(args.device)
    S, B = args.img_size, args.batch_size
    loader = train_loader(cfg, args)
    model, step, state = build_train(cfg, device, len_epoch=len(loader))
    t0 = time.time()
    losses = []
    it = 0
    for epoch in range(args.epochs):
        loader.set_epoch(epoch)
        for imgs, target in loader:
            state = step(state, *to_device(imgs, target["padded_labels"],
                                           device))
            it += 1
        if (epoch + 1) % 5 == 0 or epoch == 0:
            loss = float(state.loss)
            losses.append((epoch + 1, it, loss))
            print(f"epoch {epoch + 1}/{args.epochs} (step {it}): "
                  f"loss {loss:.1f}", flush=True)
    sync(device)
    train_seconds = time.time() - t0
    weights = model.state_dict()
    predictor = Predictor(cfg, state_dict=weights, img_size=S, batch_size=B,
                          conf_thre=CONF, nms_thre=NMS, device=device)
    ap, ap50 = validate(eval_loader(cfg, args.root, "val2017", S, B),
                        predictor, verbose=False)
    # the train split's score, for the generalization gap
    tr_ap, tr_ap50 = validate(eval_loader(cfg, args.root, "train2017", S, B),
                              predictor, verbose=False)
    seconds = time.time() - t0
    print(f"HELD-OUT val: AP {ap:.3f} AP50 {ap50:.3f} | "
          f"train split: AP {tr_ap:.3f} AP50 {tr_ap50:.3f} | "
          f"{it} steps in {seconds:.0f}s", flush=True)
    return {"mode": "manual", "losses": losses, "ap": ap, "ap50": ap50,
            "train_ap": tr_ap, "train_ap50": tr_ap50, "steps": it,
            "step_ms": 1e3 * train_seconds / max(it, 1),
            "train_seconds": train_seconds, "seconds": seconds,
            "weights": weights}


def run(cfg: Config, args: argparse.Namespace) -> Dict:
    """Prepare the dataset, train (the manual loop, or the Trainer), score
    the held-out split and, with ``--quant-eval``, the serving presets.
    Returns the result with ``launches``, K1's and K2's in this run, and
    ``weights``, the raw trained state_dict."""
    prepare_dataset(args)
    before = kernel_launches()
    result = (run_trainer if args.use_trainer else run_manual)(cfg, args)
    if args.quant_eval:
        result["quant"] = quant_ab(cfg, result["weights"], args.root,
                                   args.img_size, args.batch_size,
                                   resolve_device(args.device))
    result["launches"] = launches_since(before)
    return result


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.resume and not args.use_trainer:
        parser.error("--resume needs --use-trainer: the manual loop keeps "
                     "no checkpoint to resume")
    try:
        result = run(build_cfg(args), args)
    except DatasetMismatch as err:
        parser.error(str(err))
    if args.assert_ap50 >= 0:
        assert result["ap50"] >= args.assert_ap50, (
            f"held-out AP50 {result['ap50']:.3f} < {args.assert_ap50}")
    return result


if __name__ == "__main__":
    main()
