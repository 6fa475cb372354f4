"""Native host code of the port (C, OpenMP), the port's own copy of the
JAX package's native/ build: ``fastops.c`` holds COCOeval's greedy
matcher, built with gcc on first use into ``yolov4_tpu_torch/_build/``
under a name keyed by the source's sha256. A host without gcc gets None
from ``get_fastops`` (the build error logged once) and the caller falls
back to its numpy version."""

from __future__ import annotations

import hashlib
import importlib.util
import os
import subprocess
import sysconfig
from typing import Optional

import numpy as np

from yolov4_tpu_torch.utils.logging import get_logger

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "fastops.c")
_BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")

_fastops = None
_build_error: Optional[str] = None


def _build():
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    so_path = os.path.join(_BUILD_DIR, f"_fastops_{digest}.so")
    if not os.path.exists(so_path):
        os.makedirs(_BUILD_DIR, exist_ok=True)
        include = sysconfig.get_paths()["include"]
        # a per-pid temporary name: concurrent first builds (spawned ranks,
        # xdist workers) must not write into one file; os.replace of a
        # private file is atomic, so the last finished build wins intact
        tmp_path = f"{so_path}.{os.getpid()}.tmp"
        cmd = ["gcc", "-shared", "-fPIC", "-O3", "-fopenmp",
               f"-I{include}", _SRC, "-o", tmp_path]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"{' '.join(cmd)} failed: "
                                   f"{proc.stderr.strip()}")
            os.replace(tmp_path, so_path)
        finally:
            if os.path.exists(tmp_path):
                os.remove(tmp_path)
    spec = importlib.util.spec_from_file_location("_fastops", so_path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def get_fastops():
    """The compiled module, or None when it cannot be built here."""
    global _fastops, _build_error
    if _fastops is None and _build_error is None:
        try:
            _fastops = _build()
        except Exception as exc:  # noqa: BLE001 - no gcc: numpy fallback
            _build_error = str(exc)
            get_logger(__name__).warning(
                f"native COCOeval matcher unavailable, using the numpy "
                f"matcher: {_build_error}")
    return _fastops


def available() -> bool:
    return get_fastops() is not None


def coco_match_batch(ious_flat: np.ndarray, g_ignore: np.ndarray,
                     iscrowd: np.ndarray, d_outside: np.ndarray,
                     nd: np.ndarray, ng: np.ndarray, iou_thrs: np.ndarray):
    """COCOeval's greedy matching of every image of one (category, area
    range) at every IoU threshold in C: (matched, ignored) bool
    [T, sum(nd)], or None when the module cannot be built (the caller
    falls back to numpy)."""
    ops = get_fastops()
    if ops is None:
        return None
    t_count = int(iou_thrs.shape[0])
    total_d = int(nd.sum())
    matched = np.zeros((t_count, total_d), np.uint8)
    ignored = np.zeros((t_count, total_d), np.uint8)
    ops.coco_match(
        np.ascontiguousarray(ious_flat, np.float64),
        np.ascontiguousarray(g_ignore, np.uint8),
        np.ascontiguousarray(iscrowd, np.uint8),
        np.ascontiguousarray(d_outside, np.uint8),
        np.ascontiguousarray(nd, np.int64),
        np.ascontiguousarray(ng, np.int64),
        np.ascontiguousarray(iou_thrs, np.float64),
        matched.reshape(-1), ignored.reshape(-1))
    return matched.astype(bool), ignored.astype(bool)
