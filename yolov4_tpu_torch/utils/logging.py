"""Logging for the port's entry points (the JAX package's utils/logging.py,
the reference's rank-gated yolo/util/logging.py:24-92): on the primary
process (rank 0) the 'yolov4_tpu_torch' logger writes to stdout and, once
an output directory is known, to ``OUTPUT_DIR/stdout.log`` in the same
format; every other rank logs nothing. ``builtins.print`` is never
patched.
"""

from __future__ import annotations

import logging
import os
import sys
from typing import Optional

_FORMATTER = logging.Formatter(
    "[%(asctime)s][%(levelname)s] %(filename)s:%(lineno)3d: %(message)s",
    datefmt="%m/%d %H:%M:%S",
)
ROOT = "yolov4_tpu_torch"


def setup_logging(process_index: int = 0,
                  output_dir: Optional[str] = None) -> logging.Logger:
    """Configure the package's root logger: on process 0 stdout, plus
    ``output_dir/stdout.log`` (appended to) when ``output_dir`` is given;
    on any other process nothing. Calling it again replaces (and closes)
    the handlers."""
    logger = logging.getLogger(ROOT)
    for handler in logger.handlers:
        handler.close()
    logger.handlers = []
    logger.propagate = False
    if process_index != 0:
        logger.addHandler(logging.NullHandler())
        logger.setLevel(logging.CRITICAL + 1)
        return logger
    logger.setLevel(logging.DEBUG)
    handlers = [logging.StreamHandler(stream=sys.stdout)]
    if output_dir is not None:
        os.makedirs(output_dir, exist_ok=True)
        handlers.append(logging.FileHandler(os.path.join(output_dir,
                                                         "stdout.log")))
    for handler in handlers:
        handler.setFormatter(_FORMATTER)
        logger.addHandler(handler)
    return logger


def get_logger(name: str) -> logging.Logger:
    """Child logger under the package's root logger."""
    return logging.getLogger(f"{ROOT}.{name.split('.')[-1]}")
