"""ctypes loader for the native C++ codec core (native/exr_codec.cpp).

The native library accelerates the host-side data path (EXR block
decode/encode: zlib + EXR ZIP predictor + half<->float + interleave,
parallel across scanline blocks) — the role OpenEXR's C++ plays in the
reference (src/image_formats.cpp:208-345). Everything has a pure
numpy fallback; the loader degrades gracefully when the library is
missing or the toolchain can't build it.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
)
_LIB_PATH = os.path.join(_NATIVE_DIR, "libilr_native.so")

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
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("ILR_NO_NATIVE"):
            return None
        if not os.path.exists(_LIB_PATH) and build_if_missing:
            build_script = os.path.join(_NATIVE_DIR, "build.sh")
            if os.path.exists(build_script):
                try:
                    subprocess.run(
                        ["sh", build_script], check=True,
                        capture_output=True, timeout=300,
                    )
                except Exception:
                    return None
        if not os.path.exists(_LIB_PATH):
            return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
            if lib.ilr_version() < 1:
                return None
            _lib = _bind(lib)
        except Exception:
            return None
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
