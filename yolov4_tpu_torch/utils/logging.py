"""Logging for the port's entry points (the JAX package's utils/logging.py,
one process): the 'yolov4_tpu_torch' logger writes to stdout and, once an
output directory is known, to ``OUTPUT_DIR/stdout.log`` in the same
format. ``builtins.print`` is never patched.
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


def setup_logging(output_dir: Optional[str] = None) -> logging.Logger:
    """Configure the package's root logger: stdout, plus
    ``output_dir/stdout.log`` (appended to) when ``output_dir`` is given.
    Calling it again replaces (and closes) the handlers."""
    logger = logging.getLogger(ROOT)
    for handler in logger.handlers:
        handler.close()
    logger.handlers = []
    logger.propagate = False
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
