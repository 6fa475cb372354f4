"""Eval batches for the device: the port's copy of the JAX package's
data/pipeline.py DataLoader, in one process and in dataset order.

Each batch is (images [B, S, S, 3] uint8 NHWC, target) with the stacked
per-sample target arrays ('padded_labels', 'img_info') and 'batch_mask'.
The last short batch is padded to the full batch size by repeating its
first sample, and 'batch_mask' marks the real rows, so that the device
sees one static batch shape. Sharding across processes waits for the
data-parallel slice.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np


class DataLoader:
    """Batches of ``dataset`` in index order, the last one padded."""

    def __init__(self, dataset, batch_size: int):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self.dataset = dataset
        self.batch_size = batch_size

    def __len__(self) -> int:
        return -(-len(self.dataset) // self.batch_size)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, Dict[str, np.ndarray]]]:
        n = len(self.dataset)
        for start in range(0, n, self.batch_size):
            samples = [self.dataset[i]
                       for i in range(start, min(start + self.batch_size, n))]
            n_real = len(samples)
            samples += samples[:1] * (self.batch_size - n_real)
            imgs = np.stack([np.asarray(s[0]) for s in samples])
            target = {key: np.stack([np.asarray(s[1][key]) for s in samples])
                      for key in samples[0][1]}
            mask = np.zeros(self.batch_size, bool)
            mask[:n_real] = True
            target["batch_mask"] = mask
            yield imgs, target
