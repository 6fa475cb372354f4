"""Logging for the port's entry points (the JAX package's utils/logging.py,
one process): the 'yolov4_tpu_torch' logger writes to stdout.
``builtins.print`` is never patched.
"""

from __future__ import annotations

import logging
import sys

_FORMATTER = logging.Formatter(
    "[%(asctime)s][%(levelname)s] %(filename)s:%(lineno)3d: %(message)s",
    datefmt="%m/%d %H:%M:%S",
)
ROOT = "yolov4_tpu_torch"


def setup_logging() -> logging.Logger:
    """Configure the package's root logger; calling it again replaces the
    handler."""
    logger = logging.getLogger(ROOT)
    logger.handlers = []
    logger.propagate = False
    logger.setLevel(logging.DEBUG)
    stream = logging.StreamHandler(stream=sys.stdout)
    stream.setFormatter(_FORMATTER)
    logger.addHandler(stream)
    return logger


def get_logger(name: str) -> logging.Logger:
    """Child logger under the package's root logger."""
    return logging.getLogger(f"{ROOT}.{name.split('.')[-1]}")
