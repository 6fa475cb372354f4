"""End-to-end learning smoke: overfit 8 synthetic images and score the
trained model on them; the port's copy of the JAX package's
tools/overfit_smoke.py.

    python -m yolov4_tpu_torch.tools.overfit_smoke [--steps 300]
        [--img-size 320] [--batch-size 8] [--root DIR] [--quant-eval]
        [--device cuda]

At full width and the default config (bfloat16 autocast over float32
weights, Adam 1e-3 with a 30-step warmup, no augmentation), one fixed
batch of ``make_fake_coco`` images trains for ``--steps`` steps through
``parallel/train_step.make_train_step``; the val split (the same
generator and seed, so the same images) is then scored through the
Predictor (K1, the NMS kernel, on a card) at conf 0.3 / NMS 0.4.
``--quant-eval`` also scores the int8 and int8_static presets at spans
late and full. The CLI fails unless AP50 > 0.9. ``run(cfg, args)`` is
the smoke without the CLI: it returns the losses, AP, AP50, times and
the K1/K2 launches instead of asserting.
"""

from __future__ import annotations

import argparse
import copy
import os
import tempfile
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from yolov4_tpu_torch.config import Config, load_config
from yolov4_tpu_torch.data.coco import COCODataset
from yolov4_tpu_torch.data.pipeline import DataLoader
from yolov4_tpu_torch.data.synthetic import make_fake_coco
from yolov4_tpu_torch.data.transforms import Transform
from yolov4_tpu_torch.engine.evaluator import validate
from yolov4_tpu_torch.engine.predictor import Predictor, resolve_device
from yolov4_tpu_torch.models import build_model
from yolov4_tpu_torch.models.yolov4 import DTYPES
from yolov4_tpu_torch.ops import kernel_launches, launches_since
from yolov4_tpu_torch.ops.loss import build_criterion
from yolov4_tpu_torch.optim import build_lr_schedule, build_optimizer
from yolov4_tpu_torch.parallel import create_train_state, make_train_step

CONF, NMS = 0.3, 0.4
QUANT_PRESETS = (("int8", "late"), ("int8", "full"),
                 ("int8_static", "late"), ("int8_static", "full"))


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--steps", type=int, default=300)
    parser.add_argument("--img-size", type=int, default=320)
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--root", default=os.path.join(
        tempfile.gettempdir(), "coco_overfit"))
    parser.add_argument("--quant-eval", action="store_true",
                        help="also evaluate the trained model with "
                        "MODEL.QUANT int8 and report the AP delta")
    parser.add_argument("--device", default="cuda")
    return parser.parse_args(argv)


def build_cfg(args: argparse.Namespace) -> Config:
    """The JAX tool's config: the defaults, the smoke's size, no
    augmentation, Adam 1e-3 with one warmup epoch."""
    S, B = args.img_size, args.batch_size
    cfg = load_config()
    cfg["TRAIN"]["IMGSIZE"] = S
    cfg["TEST"].update(IMGSIZE=S, BATCH_SIZE=B, CONFTHRE=CONF, NMSTHRE=NMS)
    cfg["AUGMENTATION"].update(IS_MOSAIC=False, COLOR_DITHERING=False,
                               RANDOM_HORIZONTAL_FLIP=False, JITTER=0.0)
    cfg["OPTIMIZER"]["LR"] = 1e-3
    cfg["LR_SCHEDULER"].update(IS_WARMUP=True, WARMUP_EPOCH=1)
    return cfg


def prepare_data(args: argparse.Namespace) -> None:
    """train2017 and val2017 of B images each (the same generator and
    seed: the same images), written unless the root exists."""
    if not os.path.isdir(args.root):
        for split in ("train2017", "val2017"):
            make_fake_coco(args.root, split, n_images=args.batch_size,
                           seed=11, img_hw=(240, 320))


def fixed_batch(cfg: Config, args: argparse.Namespace
                ) -> Tuple[np.ndarray, np.ndarray]:
    """The one training batch: float32 NHWC images in [0, 1] and
    padded_labels, through the train transform (seed 0)."""
    S, B = args.img_size, args.batch_size
    ds = COCODataset(args.root, img_size=S, name="train2017", is_train=True,
                     transform=Transform(cfg, is_train=True, seed=0), seed=0)
    imgs, target = next(iter(DataLoader(ds, batch_size=B, shuffle=False)))
    return imgs, target["padded_labels"]


def eval_loader(cfg: Config, root: str, split: str, img_size: int,
                batch_size: int) -> DataLoader:
    ds = COCODataset(root, img_size=img_size, name=split,
                     transform=Transform(cfg, keep_uint8=True))
    return DataLoader(ds, batch_size=batch_size, shuffle=False)


def score(cfg: Config, state_dict: Dict[str, torch.Tensor], root: str,
          split: str, img_size: int, batch_size: int,
          device) -> Tuple[float, float]:
    """(AP, AP50) of ``state_dict`` on ``split`` through a Predictor built
    from ``cfg`` at conf 0.3 / NMS 0.4 (int8_static calibrates on the
    first batch)."""
    predictor = Predictor(cfg, state_dict=state_dict, img_size=img_size,
                          batch_size=batch_size, conf_thre=CONF,
                          nms_thre=NMS, device=device)
    loader = eval_loader(cfg, root, split, img_size, batch_size)
    return validate(loader, predictor, verbose=False)


def build_train(cfg: Config, device: torch.device, len_epoch: int,
                seed: int = 0):
    """The model (init from ``seed``), its Adam and the train step at
    ACCUMULATION_STEPS 1 with the LR schedule at ``len_epoch``."""
    model = build_model(cfg, device=device, train=True,
                        generator=torch.Generator().manual_seed(seed))
    if device.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    optimizer = build_optimizer(cfg, model)
    step = make_train_step(
        model, build_criterion(cfg), optimizer,
        build_lr_schedule(cfg, len_epoch=len_epoch), accumulation_steps=1,
        compute_dtype=DTYPES[cfg["MODEL"]["COMPUTE_DTYPE"]])
    return model, step, create_train_state(model)


def to_device(imgs: np.ndarray, labels: np.ndarray, device: torch.device):
    """A host batch as the JAX tools feed theirs: bfloat16 images."""
    images = torch.from_numpy(np.ascontiguousarray(imgs)).to(torch.bfloat16)
    return (images.to(device),
            torch.from_numpy(np.ascontiguousarray(labels)).to(device))


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(cfg: Config, args: argparse.Namespace) -> Dict:
    device = resolve_device(args.device)
    S, B = args.img_size, args.batch_size
    prepare_data(args)
    before = kernel_launches()
    model, step, state = build_train(cfg, device, len_epoch=30)
    images, labels = to_device(*fixed_batch(cfg, args), device)

    t0 = time.time()
    losses = []
    for i in range(args.steps):
        state = step(state, images, labels)
        if (i + 1) % 60 == 0 or i == 0:
            loss = float(state.loss)
            losses.append((i + 1, loss))
            print(f"step {i + 1}: loss {loss:.1f}", flush=True)
    sync(device)
    train_seconds = time.time() - t0
    weights = model.state_dict()
    ap, ap50 = score(cfg, weights, args.root, "val2017", S, B, device)
    seconds = time.time() - t0
    final_loss = float(state.loss)
    print(f"final loss {final_loss:.1f}, train-set AP {ap:.3f} "
          f"AP50 {ap50:.3f} in {seconds:.0f}s", flush=True)

    quant = {}
    if args.quant_eval:
        for mode, span in QUANT_PRESETS:
            qcfg = copy.deepcopy(cfg)
            qcfg["MODEL"].update(QUANT=mode, QUANT_SPAN=span)
            qap, qap50 = score(qcfg, weights, args.root, "val2017", S, B,
                               device)
            print(f"{mode}/{span} serving eval: AP {qap:.3f} "
                  f"(delta {qap - ap:+.4f}) AP50 {qap50:.3f} "
                  f"(delta {qap50 - ap50:+.4f})", flush=True)
            quant[f"{mode}/{span}"] = {"ap": qap, "ap50": qap50,
                                       "delta_ap": qap - ap,
                                       "delta_ap50": qap50 - ap50}
    return {"losses": losses, "final_loss": final_loss, "ap": ap,
            "ap50": ap50, "steps": args.steps,
            "step_ms": 1e3 * train_seconds / max(args.steps, 1),
            "train_seconds": train_seconds, "seconds": seconds,
            "launches": launches_since(before), "quant": quant}


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    args = parse_args(argv)
    result = run(build_cfg(args), args)
    assert result["ap50"] > 0.9, "learning smoke failed"
    return result


if __name__ == "__main__":
    main()
