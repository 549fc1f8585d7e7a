"""Build the CUDA sources of ``csrc/`` with nvcc and load them with ctypes.

A library is a list of units: a source of ``csrc/``, or a pair (source,
preprocessor definitions) for a source compiled more than once (kernel
B1, once for each input lens). Each unit is compiled to an
object by its own nvcc, all at once, and the objects are linked into one
shared library. It is built at first use into ``_build/`` inside the
package (listed in ``.gitignore``), under a name keyed on a hash of its
units, the shared headers (``csrc/*.cuh``) and the flags, so an edited
source rebuilds and an unchanged one loads at once. The sources have a plain
C interface, so no PyTorch header is compiled. Several libraries may build
at once, from several threads. A caller may name another source directory
(``source_dir``), for example to build an older version of a kernel beside
the package's own.

Each wrapper keeps one table of its library's entry points and their
argument types (``bind``), calls them directly, checks what they return
(``raise_on_error``), and counts its launches in ``COUNTS`` under the keys
it declares (``counters``).
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
from typing import Dict, List, Optional, Sequence, Tuple, Union

from ...utils import tracing

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

# -fmad=false: parity with the plain path needs every a*b+c rounded twice,
# as PyTorch's separate elementwise ops round it; a contracted FMA moves a
# source coordinate by ulps and flips truncated taps at integer boundaries.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

Unit = Union[str, Tuple[str, Tuple[str, ...]]]

_locks: Dict[str, threading.Lock] = {}
_locks_guard = threading.Lock()
# name -> (seconds the build took, or None when the library was already
# built; ptxas report; {unit label: seconds its nvcc took})
BUILD_INFO: Dict[str, tuple] = {}


def nvcc_path() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(found).exists():
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def unit_parts(unit: Unit) -> Tuple[str, Tuple[str, ...]]:
    """(source, definitions) of a unit."""
    return (unit, ()) if isinstance(unit, str) else (unit[0], tuple(unit[1]))


def unit_label(unit: Unit) -> str:
    source, defines = unit_parts(unit)
    return source + "".join(f" -D{d}" for d in defines)


def library_path(name: str, units: Sequence[Unit], source_dir: Optional[Path] = None) -> Path:
    source_dir = source_dir or CSRC_DIR
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for unit in units:
        h.update(unit_label(unit).encode())
        h.update((source_dir / unit_parts(unit)[0]).read_bytes())
    for path in sorted(source_dir.glob("*.cuh")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def _run(cmd: List[str]) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    return proc.stderr


def _compile(out: Path, units: Sequence[Unit],
             source_dir: Path) -> Tuple[str, Dict[str, float]]:
    """Compiles every unit at once, one nvcc each, then links them into ``out``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    reports: List[str] = [""] * len(units)
    seconds: Dict[str, float] = {}
    errors: List[Exception] = []

    def one(i: int, unit: Unit) -> None:
        source, defines = unit_parts(unit)
        t0 = time.perf_counter()
        try:
            reports[i] = _run([nvcc_path(), *NVCC_FLAGS, *(f"-D{d}" for d in defines), "-c",
                               "-o", str(work / f"{i}.o"), str(source_dir / source)])
        except Exception as e:  # raised below, after every unit ends
            errors.append(e)
        seconds[unit_label(unit)] = time.perf_counter() - t0

    try:
        threads = [threading.Thread(target=one, args=(i, u)) for i, u in enumerate(units)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        tmp = work / "lib.so"
        _run([nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o",
              str(tmp), *(str(work / f"{i}.o") for i in range(len(units)))])
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return "\n".join(reports), seconds


def load(name: str, units: Sequence[Unit], source_dir: Optional[Path] = None) -> ctypes.CDLL:
    """The library built from ``<source_dir>/<units>`` (``csrc/`` unless
    given), compiled first if needed.

    Callers cache what it returns (``remap_kernel.library``). A
    ``build.load`` span covers the call, its detail the library's name and
    ``nvcc`` or ``cached``.
    """
    source_dir = source_dir or CSRC_DIR
    with _locks_guard:
        lock = _locks.setdefault(name, threading.Lock())
    with tracing.trace_zone("build.load", detail=f"{name} cached") as span, lock:
        path = library_path(name, units, source_dir)
        if path.exists():
            BUILD_INFO.setdefault(name, (None, "", {}))
        else:
            span.detail = f"{name} nvcc"
            t0 = time.perf_counter()
            report, seconds = _compile(path, units, source_dir)
            BUILD_INFO[name] = (time.perf_counter() - t0, report, seconds)
        return ctypes.CDLL(str(path))


def bind(lib: ctypes.CDLL, signatures: Dict[str, list]) -> ctypes.CDLL:
    """Declares each entry point of ``signatures`` (name: argtypes) as
    returning ``int``, and ``ilr_cuda_error_string``, which every library of
    ``csrc/`` has."""
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
    lib.ilr_cuda_error_string.restype = ctypes.c_char_p
    lib.ilr_cuda_error_string.argtypes = [ctypes.c_int]
    return lib


def check_params(lib: ctypes.CDLL, params_type) -> ctypes.CDLL:
    """Checks that a remap library's ``RemapParams`` (csrc/remap_device.cuh,
    its bound ``ilr_params_size``) is the size of the wrapper's mirror."""
    if lib.ilr_params_size() != ctypes.sizeof(params_type):
        raise RuntimeError("RemapParams differs between csrc/remap_device.cuh and its wrapper")
    return lib


def raise_on_error(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raises when a launch function of ``lib`` returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} "
                           f"({lib.ilr_cuda_error_string(rc).decode()})")


# The launches of every kernel of ``csrc/``, by a dotted key of kernel and
# mode (``b1.frame``, ``b2.split``, ``probes.lane_roll``: each wrapper's
# docstring names its keys), so that a run can show which paths it took.
# A plain dict whose keys the wrappers declare at import (``counters``):
# an increment is one subscript, and a key no wrapper declared raises.
COUNTS: Dict[str, int] = {}


def counters(*keys: str) -> Dict[str, int]:
    """Declares ``keys`` in ``COUNTS``, each at 0 unless declared before,
    and returns ``COUNTS``."""
    for key in keys:
        COUNTS.setdefault(key, 0)
    return COUNTS


def reset_counts() -> None:
    """Sets every launch count of ``COUNTS`` to 0."""
    for key in COUNTS:
        COUNTS[key] = 0
