"""Host-side input pipeline: the port's copy of the JAX package's
data/pipeline.py (replacing torch DataLoader + DistributedSampler,
reference yolo/data/build.py:19-56).

Batches are NHWC numpy arrays (with AUGMENTATION.DEVICE, uint8 mosaic
canvases [B, 4, S, S, 3]) with the stacked per-sample target arrays and
'batch_mask'. Augmentation runs in spawned worker processes, one task
per sample with a bounded run-ahead of ``prefetch_batches`` batches, and
every random draw is seeded from the sample's position (seed, epoch,
batch index, slot), never from a worker's identity: any worker count
gives the same stream, and so does the JAX package's loader for the same
seed. Under data parallelism each process (rank) loads its own shard: the
epoch's order is wrap-padded to a multiple of the process count and
strided, and the per-batch seeds carry the process index.
"""

from __future__ import annotations

import multiprocessing as mp
from collections import deque
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

_WORKER_DATASET = None


def _init_worker(dataset):
    global _WORKER_DATASET
    _WORKER_DATASET = dataset


def _sample_seed(batch_seed: Optional[int], j: int) -> Optional[int]:
    """Per-sample seed from (batch seed, position in the batch)."""
    if batch_seed is None:
        return None
    return hash((batch_seed, j)) & 0x7FFFFFFF


def _load_sample(ds, idx: int, seed: Optional[int], img_size: Optional[int]):
    if seed is not None and hasattr(ds, "seed"):
        ds.seed(seed)
    if img_size is not None and hasattr(ds, "set_img_size"):
        # the size rides with the task: worker processes hold their own
        # copies of the dataset (reference hook: cocodataset.py:152-156)
        ds.set_img_size(int(img_size))
    img, target = ds[int(idx)]
    return np.asarray(img), target


def _fetch_sample(args):
    return _load_sample(_WORKER_DATASET, *args)


class DataLoader:
    """Batched, optionally shuffled and multiprocess loader.

    Yields (images [B, S, S, 3] NHWC, target dict). With ``drop_last`` a
    short last batch is dropped; otherwise, with ``pad_last``, it is
    padded to the full size by repeating its first sample, and
    'batch_mask' marks the real rows. B is the per-process batch: process
    ``process_index`` of ``process_count`` loads its shard of the epoch
    (``_local_indices``). The port's default is the eval loader (in order,
    no workers); the JAX package's shuffles.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 num_workers: int = 0, seed: int = 0, drop_last: bool = False,
                 pad_last: bool = True, process_index: int = 0,
                 process_count: int = 1, start_method: str = "spawn",
                 prefetch_batches: int = 3):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = num_workers
        self.seed = seed
        self.drop_last = drop_last
        self.pad_last = pad_last
        self.process_index = process_index
        self.process_count = process_count
        self.start_method = start_method
        self.prefetch_batches = max(1, prefetch_batches)
        self.epoch = 0
        self._pool = None
        # one-shot batch offset for a mid-epoch resume: the next iteration
        # starts at this batch index (indices, per-batch seeds and batch
        # numbering stay those of an uninterrupted epoch)
        self.start_batch = 0
        # optional multi-scale schedule: (epoch, batch_index) -> img_size,
        # shipped with each sample task
        self.size_schedule = None

    def _get_pool(self):
        if self._pool is None:
            ctx = mp.get_context(self.start_method)
            self._pool = ctx.Pool(self.num_workers, initializer=_init_worker,
                                  initargs=(self.dataset,))
        return self._pool

    def close(self) -> None:
        """Stop the worker processes (a later iteration starts new ones)."""
        if self._pool is not None:
            self._pool.terminate()
            self._pool.join()
            self._pool = None

    def set_epoch(self, epoch: int) -> None:
        """Reshuffle per epoch (DistributedSampler.set_epoch)."""
        self.epoch = epoch

    def _local_indices(self) -> np.ndarray:
        """This process's dataset indices of the epoch: the (shuffled)
        order, wrap-padded to a multiple of the process count, then every
        process_count-th from process_index. The padded copies are scored
        once (engine/evaluator.py::_dedup_wrap_padding)."""
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            order = np.random.default_rng((self.seed, self.epoch)).permutation(n)
        if self.process_count > 1:
            total = -(-n // self.process_count) * self.process_count
            order = np.concatenate([order, order[: total - n]])
            order = order[self.process_index::self.process_count]
        return order

    def __len__(self) -> int:
        n = len(self._local_indices())
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _batches(self):
        order = self._local_indices()
        start, self.start_batch = self.start_batch, 0  # consume one-shot
        for i in range(start, len(self)):
            chunk = order[i * self.batch_size:(i + 1) * self.batch_size]
            seed = hash((self.seed, self.epoch, i,
                         self.process_index)) & 0x7FFFFFFF
            if self.size_schedule is not None:
                size = self.size_schedule(self.epoch, i)
            else:
                # the dataset's current size, so worker copies follow a
                # parent-side set_img_size
                size = (self.dataset.get_img_size()
                        if hasattr(self.dataset, "get_img_size") else None)
            yield chunk, seed, size

    def _finalize(self, samples, n_real: int):
        if n_real < self.batch_size and self.pad_last:
            samples = samples + samples[:1] * (self.batch_size - n_real)
        imgs = np.stack([s[0] for s in samples])
        target = {key: np.stack([np.asarray(s[1][key]) for s in samples])
                  for key in samples[0][1]}
        mask = np.zeros(len(samples), bool)
        mask[:n_real] = True
        target["batch_mask"] = mask
        return imgs, target

    def __iter__(self) -> Iterator[Tuple[np.ndarray, Dict[str, np.ndarray]]]:
        if self.num_workers <= 0:
            for chunk, seed, size in self._batches():
                samples = [_load_sample(self.dataset, idx,
                                        _sample_seed(seed, j), size)
                           for j, idx in enumerate(chunk)]
                yield self._finalize(samples, len(chunk))
            return

        pool = self._get_pool()
        batches = list(self._batches())
        tasks = [(int(idx), _sample_seed(seed, j), size)
                 for chunk, seed, size in batches
                 for j, idx in enumerate(chunk)]
        cap = max(self.prefetch_batches * self.batch_size,
                  2 * self.num_workers)
        pending: deque = deque()
        ti = 0

        def pump():
            nonlocal ti
            while ti < len(tasks) and len(pending) < cap:
                pending.append(pool.apply_async(_fetch_sample, (tasks[ti],)))
                ti += 1

        pump()
        for chunk, _seed, _size in batches:
            samples = []
            for _ in chunk:
                samples.append(pending.popleft().get())
                pump()
            yield self._finalize(samples, len(chunk))


def build_val_loader(cfg: Dict, data_root: str, seed: int = 0,
                     process_index: int = 0,
                     process_count: int = 1) -> DataLoader:
    """val2017 in order, uint8 images (normalized on the device), this
    process's shard of it."""
    from yolov4_tpu_torch.data.coco import COCODataset
    from yolov4_tpu_torch.data.transforms import Transform

    dataset = COCODataset(
        data_root, img_size=cfg["TEST"]["IMGSIZE"],
        transform=Transform(cfg, is_train=False, keep_uint8=True),
        num_classes=cfg["MODEL"]["N_CLASSES"], name="val2017")
    return DataLoader(dataset, batch_size=cfg["TEST"].get("BATCH_SIZE", 8),
                      shuffle=False, num_workers=cfg["DATA"]["WORKERS"],
                      seed=seed, process_index=process_index,
                      process_count=process_count)


def build_data(cfg: Dict, data_root: str, seed: int = 0,
               process_index: int = 0, process_count: int = 1):
    """Train and val loaders (reference data/build.py:19) of process
    ``process_index`` of ``process_count``: its shard of train2017 with the
    train transform, shuffled, short last batch dropped; and
    build_val_loader's. DATA.BATCH_SIZE is per process. With AUGMENTATION.DEVICE the train transform is
    CanvasTransform: the host decodes and resizes the mosaic's members and
    the train step augments them on the device (data/device_aug.py)."""
    from yolov4_tpu_torch.data.coco import COCODataset
    from yolov4_tpu_torch.data.device_aug import (CanvasTransform,
                                                  device_aug_config)
    from yolov4_tpu_torch.data.transforms import Transform

    if device_aug_config(cfg) is not None:
        train_transform = CanvasTransform(cfg)
    else:
        train_transform = Transform(cfg, is_train=True)
    train_dataset = COCODataset(
        data_root, img_size=cfg["TRAIN"]["IMGSIZE"],
        transform=train_transform,
        num_classes=cfg["MODEL"]["N_CLASSES"], name="train2017",
        is_train=True)
    train_loader = DataLoader(
        train_dataset, batch_size=cfg["DATA"]["BATCH_SIZE"], shuffle=True,
        num_workers=cfg["DATA"]["WORKERS"], seed=seed, drop_last=True,
        process_index=process_index, process_count=process_count)
    return train_loader, build_val_loader(cfg, data_root, seed,
                                          process_index, process_count)
