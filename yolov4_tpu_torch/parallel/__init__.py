"""The train step, on one device or data-parallel (dist.py)."""

from yolov4_tpu_torch.parallel.train_step import (TrainState,
                                                  create_train_state,
                                                  make_train_step)

__all__ = ["TrainState", "create_train_state", "make_train_step"]
