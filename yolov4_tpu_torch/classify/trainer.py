"""CSPDarknet53 ImageNet classifier training (reference darknet/main_amp.py:
120-547): the port's copy of the JAX package's classify/trainer.py.

uint8 NHWC batches are normalized on the device with the ImageNet mean and
std (the reference's CUDA-stream prefetcher did this, main_amp.py:
284-321); cross-entropy with label smoothing 0.1 (main_amp.py:184); Adam
at lr * global_batch / 256 (main_amp.py:154-159); step LR at epochs
60/90/110 with a 5-epoch warmup applied per iteration (main_amp.py:
518-546); top-1/top-5 validation; best-prec1 checkpoints. The checkpoint's
``backbone.*`` weights are what detection training takes as
MODEL.BACKBONE_PRETRAINED.

One process per GPU, as the detection Trainer (parallel/dist.py): under
torchrun each rank trains on its shard of the train set with ``-b``
images a step; DDP averages the gradients, and the BN running statistics
are averaged over the ranks after each step (per-replica BN, the JAX
package's ``pmean(new_batch_stats)``) or, with ``--sync_bn``, every BN
normalizes with the statistics of the whole batch over the ranks
(models/layers.py::SyncBatchNorm2d). Validation is sharded too, and the
counts are summed over the ranks.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as tdist
import torch.nn.functional as F
from torch import nn

from yolov4_tpu_torch.classify.data import IMAGENET_MEAN, IMAGENET_STD
from yolov4_tpu_torch.models.darknet import CSPDarknet53
from yolov4_tpu_torch.models.decode import at_least_f32
from yolov4_tpu_torch.models.layers import convert_sync_bn
from yolov4_tpu_torch.parallel import dist as dist_lib
from yolov4_tpu_torch.parallel.train_step import TrainState
from yolov4_tpu_torch.utils import checkpoint as ckpt_lib
from yolov4_tpu_torch.utils.convert import bundle_from_jax, load_weights
from yolov4_tpu_torch.utils.logging import get_logger
from yolov4_tpu_torch.utils.metrics import AverageMeter, MetricsJSONL
from yolov4_tpu_torch.utils.profiling import StepProfiler, span

logger = get_logger(__name__)

MILESTONES = (60, 90, 110)
WARMUP_EPOCHS = 5


def classifier_lr_schedule(base_lr: float,
                           len_epoch: int) -> Callable[[int], float]:
    """Step LR at epochs 60/90/110 (gamma 0.1) with a per-iteration warmup
    over the first 5 epochs (reference darknet/main_amp.py:518-546),
    indexed by the global step, in float32 as the JAX package computes
    it."""
    def schedule(global_step: int) -> float:
        epoch = global_step // len_epoch
        factor = np.float32(sum(epoch >= m for m in MILESTONES))
        lr = np.float32(base_lr) * np.float32(0.1) ** factor
        if epoch < WARMUP_EPOCHS:
            lr = (lr * np.float32(1.0 + global_step)
                  / np.float32(WARMUP_EPOCHS * len_epoch))
        return float(lr)

    return schedule


def normalize_images(u8: torch.Tensor,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 NHWC -> the model's NCHW input, (x - 255 mean) / (255 std) in
    ``dtype`` (float32, or float64 for a float64 model), on the batch's
    device. The permuted view is channels-last in memory."""
    mean = torch.as_tensor(IMAGENET_MEAN, device=u8.device).to(dtype)
    std = torch.as_tensor(IMAGENET_STD, device=u8.device).to(dtype)
    return ((u8.to(dtype) - mean) / std).permute(0, 3, 1, 2)


def smoothed_ce(logits: torch.Tensor, labels: torch.Tensor,
                smoothing: float = 0.1) -> torch.Tensor:
    """Mean cross-entropy against the one-hot labels smoothed to (1 - s)
    one_hot + s / K, optax's ``smooth_labels`` then
    ``softmax_cross_entropy``, in at least float32."""
    return F.cross_entropy(at_least_f32(logits), labels.long(),
                           label_smoothing=smoothing)


def _param_dtype(model: nn.Module) -> torch.dtype:
    return next(model.parameters()).dtype


def make_cls_train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
                        lr_schedule: Callable[[int], float],
                        compute_dtype: torch.dtype = torch.float32,
                        dist: Optional[tdist.ProcessGroup] = None,
                        sync_bn: bool = False) -> Callable:
    """Returns step(state, u8, labels) -> state: one optimizer update on
    the uint8 NHWC batch ``u8`` with int labels, both on the model's
    device; the model, its optimizer and ``state`` change in place.

    The forward runs in train mode, under bfloat16 autocast over float32
    weights when ``compute_dtype`` is bfloat16; the loss is smoothed_ce of
    this rank's batch. The optimizer steps at ``lr_schedule(state.step)``
    (the step before its increment). Data-parallel over ``dist`` (each
    rank passing its own batch): DDP averages the gradients, the reported
    loss is the rank-mean, and without ``sync_bn`` the BN running
    statistics become their rank-means after the forward (with it, the
    model's SyncBatchNorm2d layers agree already)."""
    bn_stats = [b for n, b in model.named_buffers()
                if n.endswith(("running_mean", "running_var"))]
    autocast = compute_dtype == torch.bfloat16
    forward = model if dist is None else dist_lib.wrap_ddp(model, dist)

    def step(state: TrainState, u8: torch.Tensor,
             labels: torch.Tensor) -> TrainState:
        model.train()
        x = normalize_images(u8, _param_dtype(model))
        with span("train.forward"), torch.autocast(
                x.device.type, dtype=torch.bfloat16, enabled=autocast):
            logits = forward(x)
        loss = smoothed_ce(logits, labels)
        with span("train.backward"):
            loss.backward()
        loss = loss.detach()
        if dist is not None:
            loss = loss.clone()
            dist_lib.all_reduce_mean_([loss] + ([] if sync_bn else bn_stats),
                                      dist)
        with span("train.update"):
            lr = lr_schedule(state.step)
            for group in optimizer.param_groups:
                group["lr"] = lr
            optimizer.step()
            optimizer.zero_grad(set_to_none=True)
        state.step += 1
        state.loss = loss
        return state

    return step


def make_eval_step(model: nn.Module,
                   compute_dtype: torch.dtype = torch.float32) -> Callable:
    """Returns eval_step(u8, labels, mask) -> (top-1, top-5, rows) counts
    as device tensors over the rows where ``mask`` is true. Classes are
    ranked by a stable sort of -logits, so that ties go to the lowest
    class index, as the JAX package's ``argsort(-logits)``."""
    autocast = compute_dtype == torch.bfloat16

    @torch.no_grad()
    def eval_step(u8: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor):
        model.eval()
        x = normalize_images(u8, _param_dtype(model))
        with torch.autocast(x.device.type, dtype=torch.bfloat16,
                            enabled=autocast):
            logits = model(x)
        top5 = torch.sort(-logits, dim=-1, stable=True).indices[:, :5]
        labels = labels.long()
        correct1 = (top5[:, 0] == labels) & mask
        correct5 = (top5 == labels[:, None]).any(dim=-1) & mask
        return correct1.sum(), correct5.sum(), mask.sum()

    return eval_step


def _refuse_foreign_resume(path: str, raw) -> None:
    """A resume continues an Adam state and a schedule: the port's own, or
    a JAX package classifier ``.ckpt``'s. A file without them is refused:
    a reference classifier checkpoint (as the JAX package refuses it), or
    a JAX ``.ckpt`` without ``opt_state``."""
    if ckpt_lib.is_jax_layout(raw) and "opt_state" not in raw:
        raise ValueError(
            f"--resume {path}: this JAX package checkpoint holds no "
            "opt_state (the optimizer's state), which a classifier resume "
            "continues; evaluate its weights with -e, or graft its backbone "
            "through MODEL.BACKBONE_PRETRAINED")
    if not (isinstance(raw, dict) and "variables" in raw
            and "opt_state" in raw):
        raise ValueError(
            f"--resume {path}: classifier resume needs a checkpoint of this "
            "trainer (checkpoint.pth or model_best.pth). For reference torch "
            "weights, graft the backbone into detection training via "
            "MODEL.BACKBONE_PRETRAINED instead (the reference's optimizer "
            "state cannot resume this schedule).")


class ClassifierTrainer:
    """``ClassifierTrainer(data_root).fit()`` trains CSPDarknet53 on
    ``data_root/{train,val}/<class>/*.jpg`` on ``device`` (None means
    CUDA; a missing card is an error; a bare ``cuda`` is
    ``cuda:{LOCAL_RANK}`` in a process group) and returns the best prec1,
    the same on every rank. ``batch_size`` is per rank. Only rank 0 writes
    metrics.jsonl, checkpoints and the profiler trace.

    ``resume``: a checkpoint of this trainer, or a JAX package
    ClassifierTrainer's ``.ckpt``, to continue from (a mid-epoch one
    re-enters its epoch at the next batch). With ``evaluate_only`` it
    may also be a JAX package ``.ckpt`` or any weights file
    ``utils/convert.load_weights`` reads: the weights alone are loaded and
    evaluated."""

    def __init__(self, data_root: str, batch_size: int = 128,
                 lr: float = 0.1, epochs: int = 120, workers: int = 4,
                 crop_size: int = 256, val_size: int = 288,
                 num_classes: int = 1000,
                 output_dir: str = "./outputs/cspdarknet53",
                 print_freq: int = 10, resume: Optional[str] = None,
                 compute_dtype: torch.dtype = torch.bfloat16, seed: int = 0,
                 sync_bn: bool = False, width: float = 1.0,
                 depth: float = 1.0, profile_steps: int = 0,
                 checkpoint_every_steps: int = 0, device=None,
                 evaluate_only: bool = False):
        from yolov4_tpu_torch.classify.data import ImageFolderDataset
        from yolov4_tpu_torch.data.pipeline import DataLoader
        from yolov4_tpu_torch.engine.predictor import resolve_device

        self.device = dist_lib.device_for_rank(resolve_device(device))
        self.rank, self.world = dist_lib.rank(), dist_lib.world_size()
        self.is_primary = self.rank == 0
        self.print_freq = print_freq
        self.epochs = epochs
        self.output_dir = output_dir
        # trace window over steps [10, 10 + profile_steps): the reference's
        # nvtx/cudaProfiler --prof window (darknet/main_amp.py:350-427)
        self.profiler = StepProfiler(
            os.path.join(output_dir, "profile"), start=10,
            count=profile_steps if self.is_primary else 0)
        self.metrics_log = MetricsJSONL(
            os.path.join(output_dir, "metrics.jsonl"),
            enabled=self.is_primary)
        self.global_batch = batch_size * self.world
        # reference LR scaling: lr * global_batch / 256 (main_amp.py:154)
        self.base_lr = lr * self.global_batch / 256.0
        logger.info(f"{self.world} process(es), this one rank {self.rank} "
                    f"on {self.device}; global batch {self.global_batch}, "
                    f"base lr {self.base_lr}")

        shard = {"process_index": self.rank, "process_count": self.world}
        self.train_loader = None
        if not evaluate_only:
            # shuffled, seeded, short last batch dropped: every rank's
            # shard holds the same number of images, which SyncBN's mean of
            # the ranks' means needs to be the global batch's
            self.train_ds = ImageFolderDataset(
                f"{data_root}/train", crop_size, val_size, is_train=True,
                seed=seed)
            self.train_loader = DataLoader(
                self.train_ds, batch_size, shuffle=True,
                num_workers=workers, seed=seed, drop_last=True, **shard)
        self.val_ds = ImageFolderDataset(f"{data_root}/val", crop_size,
                                         val_size, is_train=False)
        self.val_loader = DataLoader(self.val_ds, batch_size, shuffle=False,
                                     num_workers=workers, **shard)

        self.model = CSPDarknet53(
            num_classes, width=width, depth=depth,
            generator=torch.Generator().manual_seed(seed)).to(self.device)
        if self.device.type == "cuda":
            self.model = self.model.to(memory_format=torch.channels_last)
        # SyncBN (reference darknet/main_amp.py:147-150); with one rank it
        # warns and changes nothing, as the JAX package on one device
        self.sync_bn = sync_bn and self.world > 1
        if sync_bn:
            convert_sync_bn(self.model, dist_lib.world_group())
        # torch Adam's defaults; the reference's weight decay is not
        # applied to Adam
        self.optimizer = torch.optim.Adam(self.model.parameters(),
                                          lr=self.base_lr,
                                          betas=(0.9, 0.999), eps=1e-8)
        self.lr_schedule = None
        self.train_step = None
        if not evaluate_only:
            self.lr_schedule = classifier_lr_schedule(
                self.base_lr, len(self.train_loader))
            self.train_step = make_cls_train_step(
                self.model, self.optimizer, self.lr_schedule, compute_dtype,
                dist=dist_lib.world_group(), sync_bn=self.sync_bn)
        self.eval_step = make_eval_step(self.model, compute_dtype)
        self.state = TrainState()

        self.start_epoch = 0
        self.best_prec1 = 0.0
        # every N steps the full state rolls into checkpoint.pth tagged
        # mid_epoch, so that a resume re-enters the epoch at the next
        # batch: ImageNet epochs are long; 0 = end-of-epoch saves only
        self.ckpt_every = int(checkpoint_every_steps)
        self._resume_skip = 0
        self._host_step = 0
        if resume and evaluate_only:
            logger.info(f"evaluating the weights of {resume}")
            self.model.load_state_dict(load_weights(resume))
        elif resume:
            self._resume(resume)

    def _resume(self, path: str) -> None:
        """Every rank reads the same checkpoint."""
        raw = ckpt_lib.load_checkpoint_raw(path)
        _refuse_foreign_resume(path, raw)
        if ckpt_lib.is_jax_layout(raw):
            # the JAX ClassifierTrainer's resume: variables, optax's Adam
            # state and the counters
            raw = bundle_from_jax(raw, self.optimizer, self.model, path)
        self.model.load_state_dict(raw["variables"])
        self.optimizer.load_state_dict(raw["opt_state"])
        meta = raw.get("meta", {})
        if meta.get("mid_epoch"):
            # re-enter the SAME epoch at the next batch: the loader's order
            # and per-batch seeds depend on (epoch, batch index) only
            self.start_epoch = int(meta["epoch"])
            self._resume_skip = int(meta["batch_index"])
        else:
            self.start_epoch = int(meta.get("epoch", -1)) + 1
        self.best_prec1 = float(meta.get("best_prec1", 0.0))
        if "step" in meta:
            self.state.step = int(meta["step"])
        logger.info(
            f"resumed epoch {self.start_epoch}"
            + (f" batch {self._resume_skip}" if self._resume_skip else "")
            + f" best_prec1 {self.best_prec1:.3f}")

    def _put(self, imgs: np.ndarray, labels: np.ndarray):
        """Host uint8 images and labels -> the device, from pinned memory
        on a card."""
        host = (torch.from_numpy(np.ascontiguousarray(imgs)),
                torch.from_numpy(np.asarray(labels, np.int64)))
        if self.device.type == "cuda":
            host = tuple(t.pin_memory() for t in host)
        return tuple(t.to(self.device, non_blocking=True) for t in host)

    def _bundle(self, meta):
        return {"variables": {k: v.detach().cpu() for k, v in
                              self.model.state_dict().items()},
                "opt_state": self.optimizer.state_dict(), "meta": meta}

    def train_epoch(self, epoch: int) -> None:
        self.train_loader.set_epoch(epoch)
        # a mid-epoch resume skips straight to its batch (once; later
        # epochs start at 0)
        skip, self._resume_skip = self._resume_skip, 0
        self.train_loader.start_batch = skip
        n = len(self.train_loader)
        batch_time = AverageMeter()
        end = time.time()
        for i, (imgs, target) in enumerate(self.train_loader, start=skip):
            u8, labels = self._put(imgs, target["label"])
            self.state = self.train_step(self.state, u8, labels)
            self._host_step += 1
            self.profiler.on_step(self._host_step)
            if self.ckpt_every and (i + 1) % self.ckpt_every == 0 \
                    and (i + 1) < n:
                self._save_mid_epoch(epoch, i + 1)
            if (i + 1) % self.print_freq == 0:
                loss = float(self.state.loss)   # waits for the device
                batch_time.update((time.time() - end) / self.print_freq)
                end = time.time()
                lr = self.lr_schedule(self.state.step - 1)
                ips = self.global_batch / max(batch_time.val, 1e-9)
                logger.info(
                    f"Epoch: [{epoch + 1}][{i + 1}/{n}] "
                    f"Time {batch_time.val:.3f} Speed {ips:.1f} "
                    f"Lr {lr:.6f} Loss {loss:.4f}")
                # epoch is 1-based, as in the detection Trainer's records
                self.metrics_log.write({
                    "kind": "train", "epoch": epoch + 1,
                    "step": self.state.step, "loss": loss, "lr": lr,
                    "img_s": round(ips, 1),
                    "batch_time_s": round(batch_time.val, 4)})

    def _save_mid_epoch(self, epoch: int, batch_index: int) -> None:
        """Preemption checkpoint: the full state rolls into checkpoint.pth
        (fetching it waits for the device). Rank 0 writes; the others wait
        for it."""
        if self.is_primary:
            meta = {"epoch": epoch, "batch_index": batch_index,
                    "mid_epoch": True, "step": self.state.step,
                    "best_prec1": self.best_prec1}
            ckpt_lib.save_checkpoint(self._bundle(meta), is_best=False,
                                     output_dir=self.output_dir, meta=meta)
            logger.info(f"mid-epoch checkpoint (epoch {epoch + 1} "
                        f"batch {batch_index}, step {meta['step']})")
        dist_lib.lockstep("cls_mid_epoch_saved")

    def validate(self) -> Tuple[float, float]:
        """prec1 and prec5 over the whole val set, the same on every rank:
        each scores its shard and the counts are summed over the ranks.

        Wrap-pad dedup: the sharded loader pads the global index list to a
        multiple of the rank count by wrapping (pipeline._local_indices:
        rank p serves padded positions p, p + P, ...), so a local sample
        whose padded position is >= len(dataset) is another rank's image
        served again, and is masked out. The first ceil((n - p) / P) local
        samples are the real ones."""
        n_ds = len(self.val_ds)
        real_local = max(0, -(-(n_ds - self.rank) // self.world))
        counts = torch.zeros(3, dtype=torch.int64, device=self.device)
        seen = 0
        for imgs, target in self.val_loader:
            mask = np.asarray(target["batch_mask"], bool).copy()
            mask &= seen + np.arange(len(mask)) < real_local
            seen += int(target["batch_mask"].sum())
            u8, labels = self._put(imgs, target["label"])
            counts += torch.stack(self.eval_step(
                u8, labels, torch.from_numpy(mask).to(self.device)))
        counts = counts.cpu()
        if self.world > 1:
            tdist.all_reduce(counts, op=tdist.ReduceOp.SUM,
                             group=dist_lib.host_group())
        n1, n5, total = (int(c) for c in counts)
        prec1 = 100.0 * n1 / max(total, 1)
        prec5 = 100.0 * n5 / max(total, 1)
        logger.info(f"* Prec@1 {prec1:.3f} Prec@5 {prec5:.3f}")
        return prec1, prec5

    def save(self, epoch: int, prec1: float) -> None:
        """Best-prec1 tracking on every rank (validate gave each the same
        counts); rank 0 writes the files and the others wait for it."""
        is_best = prec1 > self.best_prec1
        self.best_prec1 = max(prec1, self.best_prec1)
        if self.is_primary:
            meta = {"epoch": epoch, "step": self.state.step, "prec1": prec1,
                    "best_prec1": self.best_prec1}
            ckpt_lib.save_checkpoint(self._bundle(meta), is_best,
                                     output_dir=self.output_dir, meta=meta)
        dist_lib.lockstep("cls_saved")

    def close(self) -> None:
        """Stop the loaders' worker processes and any open trace."""
        self.profiler.close()
        for loader in (self.train_loader, self.val_loader):
            if loader is not None:
                loader.close()

    def fit(self, evaluate_only: bool = False):
        """Train from start_epoch to ``epochs``, validating and saving after
        each; returns the best prec1. ``evaluate_only``: validate once and
        return (prec1, prec5)."""
        try:
            if evaluate_only:
                return self.validate()
            dist_lib.lockstep("cls_train_start")
            for epoch in range(self.start_epoch, self.epochs):
                self.train_epoch(epoch)
                prec1, prec5 = self.validate()
                self.save(epoch, prec1)
                self.metrics_log.write({
                    "kind": "eval", "epoch": epoch + 1, "prec1": prec1,
                    "prec5": prec5, "best_prec1": self.best_prec1})
            return self.best_prec1
        finally:
            self.close()
