"""Build a CUDA source of ``csrc/`` with nvcc and load it with ctypes.

Each library is compiled at first use into ``_build/`` inside the package
(listed in ``.gitignore``), under a name keyed on a hash of its sources and
flags, so an edited ``.cu`` rebuilds and an unchanged one loads at once.
The sources have a plain C interface, so no PyTorch header is compiled.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, Sequence

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

# -fmad=false: parity with the plain path needs every a*b+c rounded twice,
# as PyTorch's separate elementwise ops round it; a contracted FMA moves a
# source coordinate by ulps and flips truncated taps at integer boundaries.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
# name -> (seconds nvcc took, or None when the library was already built; ptxas report)
BUILD_INFO: Dict[str, tuple] = {}


def nvcc_path() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(found).exists():
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def library_path(name: str, sources: Sequence[str]) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in sources:
        h.update((CSRC_DIR / s).read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def _compile(out: Path, sources: Sequence[str]) -> str:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, *(str(CSRC_DIR / s) for s in sources)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return proc.stderr


def load(name: str, sources: Sequence[str]) -> ctypes.CDLL:
    """The library built from ``csrc/<sources>``, compiled first if needed.

    Callers cache what it returns (``remap_kernel.library``).
    """
    with _lock:
        path = library_path(name, sources)
        if path.exists():
            BUILD_INFO.setdefault(name, (None, ""))
        else:
            t0 = time.perf_counter()
            report = _compile(path, sources)
            BUILD_INFO[name] = (time.perf_counter() - t0, report)
        return ctypes.CDLL(str(path))
