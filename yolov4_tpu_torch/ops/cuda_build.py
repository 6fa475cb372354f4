"""Build a kernel source of ``csrc/`` into a shared library with ``nvcc``.

Each library is compiled on first use into ``yolov4_tpu_torch/_build/``
under a name keyed by a hash of its source, the headers of its directory
that it includes (``#include "name"``, followed through the headers), and
its flags, so an edited source or header or a changed flag builds anew and
an unchanged one is reused. The sources
have a plain C interface and include no PyTorch header: a build takes
seconds, and the wrappers bind them with ``ctypes``. The compiler's output
(with ``-Xptxas -v``, each kernel's registers, shared memory and spills)
is kept beside the library as ``<library>.log``.
"""

from __future__ import annotations

import hashlib
import os
import re
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


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def build_key(source: Path, flags: Sequence[str]) -> str:
    """Hash of ``source``, every header beside it that it includes (quoted
    includes, followed through those headers, each hashed once) and
    ``flags``."""
    digest = hashlib.sha256()
    seen, todo = set(), [source]
    while todo:
        path = todo.pop(0)
        if path in seen or not path.exists():
            continue
        seen.add(path)
        text = path.read_bytes()
        digest.update(path.name.encode() + b"\0" + text + b"\0")
        todo += [path.parent / name.decode()
                 for name in _LOCAL_INCLUDE.findall(text)]
    digest.update(" ".join(flags).encode())
    return digest.hexdigest()[:16]


def build_library(source: Path, flags: Sequence[str]) -> Path:
    """Compile ``source`` with ``flags`` unless a library for this source,
    its headers and these flags is already built; return its path. A failed
    build raises ``RuntimeError`` with the compiler's output."""
    out = BUILD_DIR / f"lib{source.stem}_{build_key(source, flags)}.so"
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


def ptxas_report(log: str, name_part: str) -> list:
    """Each kernel whose mangled name holds ``name_part``, as ``-Xptxas -v``
    reports it in a build log: name, registers, static shared memory,
    stack and spill bytes."""
    rows, row = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if "'" in line else line
            row = dict(name=name) if name_part in name else None
            if row is not None:
                rows.append(row)
        elif row is not None and "Used" in line and "registers" in line:
            row["registers"] = int(re.search(r"Used (\d+) registers",
                                             line).group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            row["static_smem"] = int(smem.group(1)) if smem else 0
        elif row is not None and "spill stores" in line:
            row["stack"], row["spill_stores"], row["spill_loads"] = map(
                int, re.findall(r"(\d+) bytes", line)[:3])
    return rows
