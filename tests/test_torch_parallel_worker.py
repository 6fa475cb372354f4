"""Rank processes for tests/test_torch_parallel.py (no tests here).

``run_rank`` is the target of each spawned process: it joins a gloo group
of ``world`` ranks through a rendezvous file, runs one task and saves what
the task returns as ``<out_dir>/<task>.rank<r>.pt``. This module imports
torch and the port only, so that a rank starts without JAX.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import yaml

# every collective of a test's group gives up after this long
RANK_TIMEOUT_S = 120


def run_rank(rank: int, world: int, task: str, init_file: str, out_dir: str,
             kwargs: dict) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK="0")
    torch.set_num_threads(1)
    from yolov4_tpu_torch.parallel import dist
    dist.init_distributed(device="cpu", init_method=f"file://{init_file}",
                          timeout_s=RANK_TIMEOUT_S)
    try:
        result = TASKS[task](rank, world, **kwargs)
        torch.save(result, os.path.join(out_dir, f"{task}.rank{rank}.pt"))
    finally:
        dist.shutdown()


def _state(model) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def step_task(rank, world, cfg_raw, sd_path, imgs, labels, accum=2):
    """Two micro-steps (ACCUMULATION_STEPS 2) of the port's train step over
    the group, rank r on its slice of the global batch: the losses, this
    rank's (not yet reduced) gradient sum after the first call and the
    state after each call."""
    from yolov4_tpu_torch.config import Config
    from yolov4_tpu_torch.models import build_model
    from yolov4_tpu_torch.ops.loss import build_criterion
    from yolov4_tpu_torch.optim import build_lr_schedule, build_optimizer
    from yolov4_tpu_torch.parallel import create_train_state, make_train_step
    from yolov4_tpu_torch.parallel import dist

    cfg = Config.from_dict(cfg_raw)
    model = build_model(cfg, device="cpu", train=True)
    with np.load(sd_path) as sd:
        model.load_state_dict({k: torch.from_numpy(sd[k]) for k in sd.files})
    step = make_train_step(model, build_criterion(cfg),
                           build_optimizer(cfg, model),
                           build_lr_schedule(cfg, len_epoch=4),
                           accumulation_steps=accum, dist=dist.world_group())
    state = create_train_state(model)
    b = imgs.shape[0] // world
    x = torch.from_numpy(imgs[rank * b:(rank + 1) * b])
    y = torch.from_numpy(labels[rank * b:(rank + 1) * b])
    state = step(state, x, y)
    out = {"loss1": float(state.loss),
           "grads1": {n: p.grad.clone() for n, p in model.named_parameters()},
           "sd1": _state(model)}
    state = step(state, x, y)
    out.update(loss2=float(state.loss), sd2=_state(model), step=state.step,
               grads_cleared=all(p.grad is None for p in model.parameters()))
    return out


def skip_task(rank, world, cfg_raw, imgs, labels):
    """SKIP_NONFINITE_UPDATES over the group with a NaN in rank 1's first
    batch, then a finite batch: the state after each call."""
    from yolov4_tpu_torch.config import Config
    from yolov4_tpu_torch.models import build_model
    from yolov4_tpu_torch.ops.loss import build_criterion
    from yolov4_tpu_torch.optim import build_lr_schedule, build_optimizer
    from yolov4_tpu_torch.parallel import create_train_state, make_train_step
    from yolov4_tpu_torch.parallel import dist

    cfg = Config.from_dict(cfg_raw)
    model = build_model(cfg, device="cpu", train=True,
                        generator=torch.Generator().manual_seed(0))
    step = make_train_step(model, build_criterion(cfg),
                           build_optimizer(cfg, model),
                           build_lr_schedule(cfg, len_epoch=4),
                           skip_nonfinite=True, dist=dist.world_group())
    state = create_train_state(model)
    x = torch.from_numpy(imgs[rank])
    y = torch.from_numpy(labels)
    bad = x.clone()
    if rank == 1:
        bad[0, 0, 0, 0] = float("nan")
    out = {"sd0": _state(model)}
    state = step(state, bad, y)
    out.update(loss1=float(state.loss), step1=state.step, sd1=_state(model))
    state = step(state, x, y)
    out.update(loss2=float(state.loss), step2=state.step, sd2=_state(model))
    return out


class NoisyOracle:
    """A predictor whose detections are its batch's ground truths, jittered,
    some in the wrong class, plus false positives, drawn from each image's
    id: any split of the images over processes gives each image the same
    rows, and the AP lies strictly between 0 and 1."""

    max_dets = 20
    conf_thre = nms_thre = 0.5

    def __init__(self):
        self.target = None

    def dispatch(self, imgs):
        b = imgs.shape[0]
        det = torch.zeros((b, self.max_dets, 7))
        valid = torch.zeros((b, self.max_dets), dtype=torch.bool)
        size = imgs.shape[1]
        for i in range(b):
            rng = np.random.default_rng(int(self.target["img_info"][i][-2]))
            labels = self.target["padded_labels"][i]
            rows = []
            for cx, cy, w, h, cls in labels[labels.sum(1) > 0]:
                j = rng.normal(0, 0.1, 4) * [w, h, w, h]
                cls = cls if rng.random() < 0.8 else rng.integers(80)
                rows.append([cx - w / 2 + j[0], cy - h / 2 + j[1],
                             cx + w / 2 + j[2], cy + h / 2 + j[3],
                             rng.random(), 1.0, cls])
            for _ in range(int(rng.integers(0, 4))):
                x1, y1 = rng.uniform(0, size * 0.7, 2)
                rows.append([x1, y1, x1 + 8, y1 + 8, rng.random(), 1.0,
                             rng.integers(80)])
            n = min(len(rows), self.max_dets)
            if n:
                det[i, :n] = torch.tensor(rows[:n], dtype=torch.float32)
                valid[i, :n] = True
        return det, valid

    @staticmethod
    def fetch_local(out):
        return tuple(t.numpy() for t in out)


class OracleLoader:
    """Hands each batch's targets to the NoisyOracle before yielding it."""

    def __init__(self, loader, predictor):
        self.loader, self.predictor = loader, predictor
        self.dataset = loader.dataset

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        for imgs, target in self.loader:
            self.predictor.target = target
            yield imgs, target


def oracle_validate(root, process_index=0, process_count=1):
    """validate() with the NoisyOracle over val2017 at 64x64, batch 2, on
    this process's shard."""
    from yolov4_tpu_torch.config import load_config
    from yolov4_tpu_torch.data.coco import COCODataset
    from yolov4_tpu_torch.data.pipeline import DataLoader
    from yolov4_tpu_torch.data.transforms import Transform
    from yolov4_tpu_torch.engine.evaluator import validate

    cfg = load_config()
    dataset = COCODataset(root, img_size=64,
                          transform=Transform(cfg, keep_uint8=True))
    loader = DataLoader(dataset, batch_size=2, process_index=process_index,
                        process_count=process_count)
    predictor = NoisyOracle()
    return validate(OracleLoader(loader, predictor), predictor,
                    conf_threshold=0.001, verbose=False)


def gather_rows(rank, n_rows, ids):
    """Rows with an image id and a score per rank: (image id, score) for
    row k of rank r is (ids[k % len(ids)], r + k / 100)."""
    return [{"image_id": ids[k % len(ids)], "category_id": 1 + rank,
             "bbox": [k, 2.5 * k, 3.0, 4.0 + rank], "score": rank + k / 100}
            for k in range(n_rows)]


def validate_task(rank, world, root, rows_per_rank, ids_per_rank):
    """The multi-process validate on this rank's shard, and _gather_rows
    on rows of unequal counts per rank."""
    from yolov4_tpu_torch.engine.evaluator import _gather_rows
    from yolov4_tpu_torch.parallel import dist

    ap, ap50 = oracle_validate(root, rank, world)
    ids = ids_per_rank[rank]
    rows, gathered_ids = _gather_rows(
        gather_rows(rank, rows_per_rank[rank], ids), ids, dist.host_group())
    return {"ap": ap, "ap50": ap50, "rows": rows, "ids": gathered_ids}


def fit_task(rank, world, root, cfg_raw, out_dir):
    """``python -m yolov4_tpu_torch.train`` on this rank, with its own
    OUTPUT_DIR (``<out_dir>/r<rank>``) so that whatever it writes shows."""
    from yolov4_tpu_torch import train

    cfg_raw = {k: dict(v) for k, v in cfg_raw.items()}
    cfg_raw["TRAIN"]["OUTPUT_DIR"] = os.path.join(out_dir, f"r{rank}")
    cfg_path = os.path.join(out_dir, f"cfg.rank{rank}.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg_raw, f)
    ap, ap50 = train.main([root, "-c", cfg_path, "--device", "cpu",
                           "--print-freq", "1"])
    return {"ap": ap, "ap50": ap50}


def resume_task(rank, world, root, cfg_raw, ckpt):
    """``Trainer.fit`` on this rank resumed from ``ckpt``: where it resumed
    and the state it ends with."""
    from yolov4_tpu_torch.config import Config
    from yolov4_tpu_torch.engine.trainer import Trainer

    trainer = Trainer(Config.from_dict(cfg_raw), root, resume=ckpt,
                      device="cpu", print_freq=1)
    resumed_at = (trainer.start_epoch, trainer.state.step)
    ap, ap50 = trainer.fit()
    return {"resumed_at": resumed_at, "step": trainer.state.step,
            "ap": ap, "ap50": ap50, "sd": _state(trainer.model)}


TASKS = {"step": step_task, "skip": skip_task, "validate": validate_task,
         "fit": fit_task, "resume": resume_task}
