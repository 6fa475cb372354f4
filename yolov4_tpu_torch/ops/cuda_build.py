"""Build a kernel source of ``csrc/`` into a shared library with ``nvcc``.

Each library is compiled on first use into ``yolov4_tpu_torch/_build/``
under a name keyed by a hash of its source and flags, so an edited source
or a changed flag builds anew and an unchanged one is reused. The sources
have a plain C interface and include no PyTorch header: a build takes
seconds, and the wrappers bind them with ``ctypes``. The compiler's output
(with ``-Xptxas -v``, each kernel's registers, shared memory and spills)
is kept beside the library as ``<library>.log``.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Sequence

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
# Hopper only: the "a" target keeps wgmma and setmaxnreg available
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMMON_FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC")


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(cuda_home, "bin", "nvcc")


def build_library(source: Path, flags: Sequence[str]) -> Path:
    """Compile ``source`` with ``flags`` unless a library for this source
    and these flags is already built; return its path. A failed build
    raises ``RuntimeError`` with the compiler's output."""
    src = source.read_bytes()
    key = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{source.stem}_{key}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *flags, "-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}"
                           f"\n{proc.stdout}\n{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out
