"""ctypes loader for the native C++ codec core (native/exr_codec.cpp).

The native library accelerates the host-side data path (EXR block
decode/encode: zlib + EXR ZIP predictor + half<->float + interleave,
parallel across scanline blocks) — the role OpenEXR's C++ plays in the
reference (src/image_formats.cpp:208-345). Everything has a pure
numpy fallback, for a machine with no C++ compiler.

The library is built at first use from ``native/exr_codec.cpp`` (read,
never written) into the package's ``_build/native/`` (listed in
``.gitignore``), under a name keyed on the source and the flags. Several
processes may load at once: the build runs under an exclusive ``flock`` on
a lock file there, into a directory of its own, and the finished library
is moved into place with one ``os.replace``, so a loader sees all of it or
none. A failed build warns with the compiler's error output and leaves it in
``BUILD_ERROR``; the EXR code then takes the numpy path.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
import warnings
from typing import Optional

import numpy as np

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False

_PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(os.path.dirname(_PACKAGE_DIR), "native", "exr_codec.cpp")
BUILD_DIR = os.path.join(_PACKAGE_DIR, "_build", "native")
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC")
LINK_FLAGS = ("-lz", "-lpthread")

# Set by load(): the library it loaded, the seconds this process spent
# building it (None when it was built already), and why a build failed.
LIBRARY_PATH: Optional[str] = None
BUILD_SECONDS: Optional[float] = None
BUILD_ERROR: Optional[str] = None


def compiler() -> Optional[str]:
    return os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")


def library_path(build_dir: str = BUILD_DIR) -> str:
    """Where the library built from the current source and flags lies."""
    h = hashlib.sha256(" ".join(CXX_FLAGS + LINK_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(build_dir, f"libilr_native_{h.hexdigest()[:16]}.so")


def build(build_dir: str = BUILD_DIR) -> str:
    """Builds the library into ``build_dir`` unless it is there; returns its path.

    Safe to call from several processes at once. Raises ``RuntimeError``
    with the compiler's error output when the build fails.
    """
    path = library_path(build_dir)
    os.makedirs(build_dir, exist_ok=True)
    with open(os.path.join(build_dir, "build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if os.path.exists(path):
            return path
        cxx = compiler()
        if cxx is None:
            raise RuntimeError("no C++ compiler: set CXX or put g++ on PATH")
        work = tempfile.mkdtemp(dir=build_dir)
        try:
            tmp = os.path.join(work, "lib.so")
            proc = subprocess.run([cxx, *CXX_FLAGS, SOURCE, "-o", tmp, *LINK_FLAGS],
                                  capture_output=True, text=True, timeout=300)
            if proc.returncode != 0:
                raise RuntimeError(f"{cxx} failed ({proc.returncode}) on {SOURCE}:\n{proc.stderr}")
            os.replace(tmp, path)
        finally:
            shutil.rmtree(work, ignore_errors=True)
    return path


_u8p = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS")
_u64p = np.ctypeslib.ndpointer(dtype=np.uint64, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
_f32p = np.ctypeslib.ndpointer(dtype=np.float32, flags="C_CONTIGUOUS")


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.ilr_version.restype = ctypes.c_int
    lib.ilr_exr_decode.restype = ctypes.c_int
    lib.ilr_exr_decode.argtypes = [
        _u8p, ctypes.c_uint64, _u64p, ctypes.c_int,  # data, size, offsets, n_blocks
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # comp, lpb, w, h, ymin
        ctypes.c_int, _i32p, _i32p, ctypes.c_int,  # n_channels, types, slots, out_channels
        _f32p, ctypes.c_int,  # out, n_threads
    ]
    lib.ilr_exr_encode_blocks.restype = ctypes.c_int
    lib.ilr_exr_encode_blocks.argtypes = [
        _f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, _i32p,
        ctypes.c_int, ctypes.c_int, _u8p, ctypes.c_uint64, _u64p, ctypes.c_int,
    ]
    return lib


def load(build_if_missing: bool = True) -> Optional[ctypes.CDLL]:
    """Load (building on first use if needed) the native library, or None."""
    global _lib, _tried, LIBRARY_PATH, BUILD_SECONDS, BUILD_ERROR
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("ILR_NO_NATIVE"):
            return None
        t0 = time.perf_counter()
        try:
            path = library_path()
            if not os.path.exists(path):
                if not build_if_missing:
                    return None
                path = build()
                BUILD_SECONDS = time.perf_counter() - t0
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            BUILD_ERROR = str(e)
            warnings.warn(f"native EXR codec not built, using numpy: {e}", RuntimeWarning)
            return None
        lib = ctypes.CDLL(path)
        if lib.ilr_version() < 1:
            raise RuntimeError(f"{path}: unexpected native codec version {lib.ilr_version()}")
        _lib = _bind(lib)
        LIBRARY_PATH = path
        return _lib


def available() -> bool:
    return load() is not None


def default_threads() -> int:
    return max(1, min(16, os.cpu_count() or 1))


def exr_decode(
    file_data: bytes,
    block_offsets: np.ndarray,
    compression: int,
    lines_per_block: int,
    width: int,
    height: int,
    ymin: int,
    pixel_types: np.ndarray,
    dst_slots: np.ndarray,
    out_channels: int,
    n_threads: Optional[int] = None,
) -> Optional[np.ndarray]:
    """Native all-blocks decode -> (H, W, C) float32, or None if unavailable."""
    lib = load()
    if lib is None:
        return None
    buf = np.frombuffer(file_data, dtype=np.uint8)
    out = np.zeros((height, width, out_channels), dtype=np.float32)
    rc = lib.ilr_exr_decode(
        buf, buf.size,
        np.ascontiguousarray(block_offsets, dtype=np.uint64), len(block_offsets),
        compression, lines_per_block, width, height, ymin,
        len(pixel_types),
        np.ascontiguousarray(pixel_types, dtype=np.int32),
        np.ascontiguousarray(dst_slots, dtype=np.int32),
        out_channels, out, n_threads or default_threads(),
    )
    if rc != 0:
        return None
    return out


def exr_encode_blocks(
    img: np.ndarray,
    sort_order: np.ndarray,
    lines_per_block: int,
    level: int,
    n_threads: Optional[int] = None,
):
    """Native parallel block encode -> list[bytes] (compressed or raw), or None."""
    lib = load()
    if lib is None:
        return None
    h, w, c = img.shape
    n_blocks = (h + lines_per_block - 1) // lines_per_block
    raw_size = lines_per_block * c * w * 2
    stride = raw_size + 64
    out = np.empty(n_blocks * stride, dtype=np.uint8)
    sizes = np.zeros(n_blocks, dtype=np.uint64)
    rc = lib.ilr_exr_encode_blocks(
        np.ascontiguousarray(img, dtype=np.float32), w, h, c,
        np.ascontiguousarray(sort_order, dtype=np.int32),
        lines_per_block, level, out, stride, sizes,
        n_threads or default_threads(),
    )
    if rc != 0:
        return None
    return [out[b * stride : b * stride + int(sizes[b])].tobytes() for b in range(n_blocks)]
