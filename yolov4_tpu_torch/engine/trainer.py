"""Training engine (reference main_amp.py:61-235 + engine/build.py:41-108):
the port's copy of the JAX package's engine/trainer.py.

One process per GPU: under torchrun (parallel/dist.py) each rank trains
on ``cuda:{LOCAL_RANK}`` with its shard of the loaders, DATA.BATCH_SIZE
images a step, and the train step averages gradients, BN statistics and
the loss over the ranks; every rank validates its shard of val2017 and
gets the stats of the whole set. Only rank 0 writes metrics.jsonl,
checkpoints and the profiler trace; every rank reads the same checkpoint
to resume.

Epoch loop: host loading in worker processes -> an upload of each batch
(TRAIN.TRANSFER_DTYPE on the host, pinned; with AUGMENTATION.DEVICE the
uint8 mosaic canvases and member boxes, augmented inside the step on the
device) -> one train step per batch
(forward, loss, backward, accumulation, optimizer, LR, EMA; see
parallel/train_step.py) -> periodic throughput/loss logging -> COCO
validation through the Predictor after each epoch (the greedy-NMS kernel
K1 runs there, and the fused CSP kernel K2 too under MODEL.PALLAS_CSP) ->
checkpoints with best-AP50 tracking (the reference's criterion,
main_amp.py:215-218) and full-state resume (parameters, BN statistics,
optimizer, counters, EMA; the reference's optimizer restore was dead
code).
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from yolov4_tpu_torch.data.device_aug import device_aug_config
from yolov4_tpu_torch.data.pipeline import build_data, build_val_loader
from yolov4_tpu_torch.engine.evaluator import validate
from yolov4_tpu_torch.engine.predictor import Predictor, resolve_device
from yolov4_tpu_torch.models import build_model
from yolov4_tpu_torch.models.yolov4 import DTYPES
from yolov4_tpu_torch.ops.loss import build_criterion
from yolov4_tpu_torch.optim import build_lr_schedule, build_optimizer
from yolov4_tpu_torch.parallel import create_train_state, make_train_step
from yolov4_tpu_torch.parallel import dist as dist_lib
from yolov4_tpu_torch.utils import checkpoint as ckpt_lib
from yolov4_tpu_torch.utils.logging import get_logger
from yolov4_tpu_torch.utils.metrics import AverageMeter, MetricsJSONL
from yolov4_tpu_torch.utils.profiling import StepProfiler

logger = get_logger(__name__)


def _kernel_launches() -> Dict[str, int]:
    """The launch counts of the NMS kernel (K1) and the fused CSP stage
    kernel (K2) in this process so far."""
    from yolov4_tpu_torch.ops import csp_cuda, nms_cuda
    return {"greedy_nms_mask": nms_cuda.greedy_nms_mask_cuda.launches,
            "fused_csp_stage": csp_cuda.fused_csp_stage_cuda.launches}


class Trainer:
    """``Trainer(cfg, data_root).fit()`` trains for TRAIN.MAX_EPOCHS on
    ``device`` (None means CUDA; a missing card is an error; a bare
    ``cuda`` is ``cuda:{LOCAL_RANK}`` in a process group) and returns
    (best AP[.50:.95], best AP50), the same on every rank."""

    def __init__(self, cfg: Dict, data_root: str, resume: Optional[str] = None,
                 print_freq: int = 10, seed: int = 0, profile_steps: int = 0,
                 evaluate_only: bool = False, device=None,
                 channels_last: bool = True):
        self.cfg = cfg
        self.device = dist_lib.device_for_rank(resolve_device(device))
        self.rank, self.world = dist_lib.rank(), dist_lib.world_size()
        self.is_primary = self.rank == 0
        self.print_freq = print_freq
        self.output_dir = cfg["TRAIN"]["OUTPUT_DIR"]
        self.profiler = StepProfiler(
            os.path.join(self.output_dir, "profile"), start=10,
            count=profile_steps if self.is_primary else 0)
        self.metrics_log = MetricsJSONL(
            os.path.join(self.output_dir, "metrics.jsonl"),
            enabled=self.is_primary)
        logger.info(f"{self.world} process(es), this one rank {self.rank} "
                    f"on {self.device}")

        shard = {"process_index": self.rank, "process_count": self.world}
        if evaluate_only:
            self.train_loader = None
            self.val_loader = build_val_loader(cfg, data_root, seed=seed,
                                               **shard)
        else:
            self.train_loader, self.val_loader = build_data(
                cfg, data_root, seed=seed, **shard)

        self.model = build_model(cfg, device=self.device, train=True,
                                 generator=torch.Generator().manual_seed(seed))
        if self.device.type == "cuda" and channels_last:
            self.model = self.model.to(memory_format=torch.channels_last)
        pretrained = cfg["MODEL"].get("BACKBONE_PRETRAINED")
        if pretrained and os.path.isfile(pretrained):
            logger.info(f"loading pretrained backbone: {pretrained}")
            ckpt_lib.load_pretrained_backbone(self.model, pretrained)
        elif pretrained:
            logger.warning(f"BACKBONE_PRETRAINED not found, skipping: "
                           f"{pretrained}")

        self.criterion = build_criterion(cfg)
        self.optimizer = build_optimizer(cfg, self.model)
        # this rank's batches per epoch (the JAX package's per-process
        # batch count)
        len_epoch = len(self.train_loader) if self.train_loader else 1
        self.lr_schedule = build_lr_schedule(cfg, len_epoch=len_epoch)
        # opt-in parameter EMA (TRAIN.EMA_DECAY > 0): evaluation and the
        # best checkpoint score the shadow weights
        self.ema_decay = float(cfg["TRAIN"].get("EMA_DECAY", 0.0))
        # opt-in multi-scale training (TRAIN.MULTISCALE, the reference's
        # dead RANDOM_RESIZE path, engine/build.py:105-107)
        self.ms_sizes = [int(s) for s in (cfg["TRAIN"].get("MULTISCALE")
                                          or [])]
        self.ms_every = int(cfg["TRAIN"].get("MULTISCALE_EVERY", 10))
        self._seed = seed
        # AUGMENTATION.DEVICE: the host decodes and resizes the mosaic's
        # members, the step augments them (data/device_aug.py)
        self.device_aug = device_aug_config(cfg)
        if self.device_aug is not None:
            logger.info("device-side augmentation enabled")
        self.state = create_train_state(self.model, ema=self.ema_decay > 0)
        self.train_step = None
        if not evaluate_only:
            self.train_step = make_train_step(
                self.model, self.criterion, self.optimizer, self.lr_schedule,
                accumulation_steps=cfg["TRAIN"]["ACCUMULATION_STEPS"],
                compute_dtype=DTYPES[cfg["MODEL"]["COMPUTE_DTYPE"]],
                skip_nonfinite=bool(cfg["TRAIN"].get("SKIP_NONFINITE_UPDATES",
                                                     False)),
                ema_decay=self.ema_decay, device_aug=self.device_aug,
                aug_seed=seed, dist=dist_lib.world_group())

        self.start_epoch = cfg["TRAIN"]["START_EPOCH"]
        self.best_ap50 = 0.0
        self.best_ap50_95 = 0.0
        # every N steps the full state rolls into checkpoint.pth tagged
        # mid_epoch, so that a resume re-enters the epoch at the next
        # batch; 0 = end-of-epoch saves only (the reference's cadence)
        self.ckpt_every = int(cfg["TRAIN"].get("CHECKPOINT_EVERY_STEPS", 0))
        self._resume_skip = 0
        self._host_step = 0
        # K1/K2 launches of the last evaluate()
        self.eval_launches: Dict[str, int] = {}
        if resume:
            self._resume(resume)

        self.predictor = Predictor(cfg, batch_size=cfg["TEST"].get(
            "BATCH_SIZE", 8), device=self.device)

    # ------------------------------------------------------------------
    def _ms_size_for(self, epoch: int, batch_index: int) -> int:
        """Multi-scale draw: one size per MULTISCALE_EVERY batches, seeded
        by (seed, epoch, segment), so that a resume draws the same sizes."""
        seg = batch_index // self.ms_every
        rng = np.random.default_rng((self._seed, 7919, epoch, seg))
        return int(self.ms_sizes[rng.integers(len(self.ms_sizes))])

    def _named_state(self, ema: bool) -> Dict[str, torch.Tensor]:
        """The model's state_dict on the CPU, with the EMA weights in place
        of the parameters when ``ema``."""
        sd = {k: v.detach().cpu() for k, v in self.model.state_dict().items()}
        if ema:
            sd.update({k: v.cpu() for k, v in self.state.ema_params.items()})
        return sd

    def _bundle(self, meta: Dict) -> Dict:
        """The full state: with an EMA, ``variables`` holds the EMA weights
        (what evaluate() scored) and ``raw_params`` the training ones."""
        ema = self.state.ema_params is not None
        bundle = {"variables": self._named_state(ema),
                  "opt_state": self.optimizer.state_dict(), "meta": meta}
        if ema:
            meta["ema_decay"] = self.ema_decay
            bundle["raw_params"] = {n: p.detach().cpu()
                                    for n, p in self.model.named_parameters()}
        return bundle

    def _resume(self, path: str) -> None:
        """Every rank reads the same checkpoint."""
        logger.info(f"resuming from {path}")
        raw = ckpt_lib.load_checkpoint_raw(path)
        if "variables" not in raw:
            raise ValueError(f"{path} is not a training checkpoint of the "
                             "port (no 'variables'); use "
                             "MODEL.BACKBONE_PRETRAINED or val for weights")
        variables = raw["variables"]
        train_sd = dict(variables)
        train_sd.update(raw.get("raw_params", {}))
        self.model.load_state_dict(train_sd)
        if self.state.ema_params is not None:
            # an EMA checkpoint resumes its average; a plain one seeds it
            # from its parameters
            for name, ema in self.state.ema_params.items():
                ema.copy_(variables[name])
        if "opt_state" in raw:
            self.optimizer.load_state_dict(raw["opt_state"])
        meta = raw.get("meta", {})
        if meta.get("mid_epoch"):
            # re-enter the SAME epoch at the next batch: loader order and
            # per-batch seeds depend on (epoch, batch index) only
            self.start_epoch = int(meta["epoch"])
            self._resume_skip = int(meta["batch_index"])
        else:
            self.start_epoch = int(meta.get("epoch", -1)) + 1
        self.best_ap50 = float(meta.get("best_ap50", 0.0))
        self.best_ap50_95 = float(meta.get("best_ap50_95", 0.0))
        if "step" in meta:
            self.state.step = int(meta["step"])
        logger.info(
            f"resumed at epoch {self.start_epoch}"
            + (f" batch {self._resume_skip}" if self._resume_skip else "")
            + f", step {self.state.step}, best AP50 {self.best_ap50}")

    def _put_batch(self, imgs: np.ndarray, labels: np.ndarray):
        """Host float32 NHWC batch -> device tensors, the images converted
        on the host to TRAIN.TRANSFER_DTYPE (bfloat16 halves the bytes,
        uint8 quarters them) and uploaded from pinned memory. Device-aug
        canvases [B, 4, S, S, 3] are uint8 already and go up as they are."""
        transfer = self.cfg["TRAIN"].get("TRANSFER_DTYPE", "bfloat16")
        if imgs.ndim == 5:
            host = torch.from_numpy(np.ascontiguousarray(imgs))
        elif transfer == "uint8":
            host = torch.from_numpy(
                np.clip(imgs * 255.0 + 0.5, 0, 255).astype(np.uint8))
        else:
            host = torch.from_numpy(np.ascontiguousarray(imgs))
            if transfer == "bfloat16":
                host = host.to(torch.bfloat16)
        host_labels = torch.from_numpy(np.ascontiguousarray(labels))
        if self.device.type == "cuda":
            host, host_labels = host.pin_memory(), host_labels.pin_memory()
        return (host.to(self.device, non_blocking=True),
                host_labels.to(self.device, non_blocking=True))

    # ------------------------------------------------------------------
    def train_epoch(self, epoch: int) -> float:
        cfg = self.cfg
        self.train_loader.set_epoch(epoch)
        skip, self._resume_skip = self._resume_skip, 0
        self.train_loader.start_batch = skip
        n_batches = len(self.train_loader)
        batch_time = AverageMeter()
        batch = cfg["DATA"]["BATCH_SIZE"] * self.world   # over the ranks
        loss_val = float("nan")
        if self.ms_sizes:
            # the loader evaluates the same schedule per batch
            self.train_loader.size_schedule = self._ms_size_for
        cur_size = cfg["TRAIN"]["IMGSIZE"]
        label_key = ("member_boxes" if self.device_aug is not None
                     else "padded_labels")
        t_epoch = end = time.time()
        n_images = 0
        for i, (imgs, target) in enumerate(self.train_loader, start=skip):
            cur_size = imgs.shape[-2]
            images, labels = self._put_batch(imgs, target[label_key])
            self.state = self.train_step(self.state, images, labels)
            n_images += imgs.shape[0] * self.world
            self._host_step += 1
            self.profiler.on_step(self._host_step)
            if self.ckpt_every and (i + 1) % self.ckpt_every == 0 \
                    and (i + 1) < n_batches:
                self._save_mid_epoch(epoch, i + 1)

            if (i + 1) % self.print_freq == 0:
                loss_val = float(self.state.loss)  # waits for the device
                batch_time.update((time.time() - end) / self.print_freq)
                end = time.time()
                lr = self.lr_schedule(self.state.step - 1)
                ips = batch / max(batch_time.val, 1e-9)
                logger.info(
                    f"Epoch: [{epoch + 1}][{i + 1}/{n_batches}] "
                    f"Time {batch_time.val:.3f} ({batch_time.avg:.3f}) "
                    f"Speed {ips:.1f} img/s "
                    f"Lr {lr:.8f} "
                    f"Loss {loss_val:.4f} "
                    f"ImgSize: {cur_size}x{cur_size}")
                self.metrics_log.write({
                    "kind": "train", "epoch": epoch + 1,
                    "step": self.state.step, "loss": loss_val,
                    "lr": lr, "img_s": round(ips, 1),
                    "batch_time_s": round(batch_time.val, 4)})
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        seconds = time.time() - t_epoch
        self.metrics_log.write({
            "kind": "train_epoch", "epoch": epoch + 1, "images": n_images,
            "seconds": seconds, "img_s": n_images / max(seconds, 1e-9)})
        return loss_val

    def _save_mid_epoch(self, epoch: int, batch_index: int) -> None:
        """Preemption checkpoint (TRAIN.CHECKPOINT_EVERY_STEPS): the full
        state rolls into checkpoint.pth; fetching it waits for the device,
        so pick a cadence of hundreds of steps on real configs. Rank 0
        writes; the others wait for it."""
        if self.is_primary:
            meta = {"epoch": epoch, "batch_index": batch_index,
                    "mid_epoch": True, "step": self.state.step,
                    "best_ap50": self.best_ap50,
                    "best_ap50_95": self.best_ap50_95}
            ckpt_lib.save_checkpoint(self._bundle(meta), is_best=False,
                                     output_dir=self.output_dir, meta=meta)
            logger.info(f"mid-epoch checkpoint (epoch {epoch + 1} "
                        f"batch {batch_index}, step {meta['step']})")
        dist_lib.lockstep("mid_epoch_saved")

    def evaluate(self):
        """COCO AP of the EMA weights when enabled (what a deployment would
        serve), else of the training weights, through the Predictor; each
        rank on its shard of val2017. Counts the K1/K2 launches it made
        into ``eval_launches``."""
        self.predictor.model.load_state_dict(
            self._named_state(self.state.ema_params is not None))
        before = _kernel_launches()
        stats = validate(self.val_loader, self.predictor,
                         conf_threshold=self.cfg["TEST"]["CONFTHRE"],
                         nms_threshold=self.cfg["TEST"]["NMSTHRE"])
        self.eval_launches = {k: v - before[k]
                              for k, v in _kernel_launches().items()}
        return stats

    def save(self, epoch: int, ap50: float, ap50_95: float) -> None:
        """Best-AP tracking on every rank (validate gave each the same
        stats), so fit returns the same on all; rank 0 writes the files
        and the others wait for it."""
        is_best = ap50 > self.best_ap50
        self.best_ap50 = max(ap50, self.best_ap50)
        self.best_ap50_95 = max(ap50_95, self.best_ap50_95)
        if not self.is_primary:
            dist_lib.lockstep("saved")
            return
        meta = {"epoch": epoch, "step": self.state.step,
                "ap50": ap50, "ap50_95": ap50_95,
                "best_ap50": self.best_ap50,
                "best_ap50_95": self.best_ap50_95}
        ckpt_lib.save_checkpoint(self._bundle(meta), is_best,
                                 output_dir=self.output_dir, meta=meta)
        logger.info(f"checkpoint saved (epoch {epoch}, best={is_best})")
        dist_lib.lockstep("saved")

    def close(self) -> None:
        """Stop the loaders' worker processes and any open trace."""
        self.profiler.close()
        for loader in (self.train_loader, self.val_loader):
            if loader is not None:
                loader.close()

    def fit(self, evaluate_only: bool = False):
        try:
            if evaluate_only:
                ap, ap50 = self.evaluate()
                logger.info(f"AP[.50:.95] = {ap:.5f}  AP50 = {ap50:.5f}")
                return ap, ap50
            dist_lib.lockstep("train_start")
            for epoch in range(self.start_epoch,
                               self.cfg["TRAIN"]["MAX_EPOCHS"]):
                t0 = time.time()
                self.train_epoch(epoch)
                logger.info(f"epoch {epoch + 1} trained in "
                            f"{time.time() - t0:.1f}s")
                ap, ap50 = self.evaluate()
                self.save(epoch, ap50, ap)
                logger.info(f"epoch {epoch + 1}: AP {ap:.5f} AP50 {ap50:.5f} "
                            f"(best AP50 {self.best_ap50:.5f})")
                self.metrics_log.write({
                    "kind": "eval", "epoch": epoch + 1, "ap": ap,
                    "ap50": ap50, "best_ap50": self.best_ap50,
                    "launches": self.eval_launches})
            return self.best_ap50_95, self.best_ap50
        finally:
            self.close()
