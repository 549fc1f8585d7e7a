"""Build a CUDA source of ``csrc/`` with nvcc and load it with ctypes.

Each library is compiled at first use into ``_build/`` inside the package
(listed in ``.gitignore``), under a name keyed on a hash of its sources, the
shared headers (``csrc/*.cuh``) and the flags, so an edited source rebuilds
and an unchanged one loads at once. The sources have a plain C interface,
so no PyTorch header is compiled. Two libraries may build at once (one
nvcc each), from two threads.
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

_locks: Dict[str, threading.Lock] = {}
_locks_guard = threading.Lock()
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
    for path in [CSRC_DIR / s for s in sources] + sorted(CSRC_DIR.glob("*.cuh")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
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
    with _locks_guard:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        path = library_path(name, sources)
        if path.exists():
            BUILD_INFO.setdefault(name, (None, ""))
        else:
            t0 = time.perf_counter()
            report = _compile(path, sources)
            BUILD_INFO[name] = (time.perf_counter() - t0, report)
        return ctypes.CDLL(str(path))


def check_common(lib: ctypes.CDLL, params_type) -> ctypes.CDLL:
    """Binds the entry points every library of ``csrc/`` has and checks that
    its ``RemapParams`` is the size of the wrapper's mirror."""
    lib.ilr_cuda_error_string.restype = ctypes.c_char_p
    lib.ilr_cuda_error_string.argtypes = [ctypes.c_int]
    lib.ilr_params_size.restype = ctypes.c_int
    lib.ilr_params_size.argtypes = []
    if lib.ilr_params_size() != ctypes.sizeof(params_type):
        raise RuntimeError("RemapParams differs between csrc/remap_device.cuh and its wrapper")
    return lib
