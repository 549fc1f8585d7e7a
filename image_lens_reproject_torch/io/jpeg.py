"""JPEG read/write with the reference's gamma-2.2 conversions.

Reference: src/image_formats.cpp:26-140. JPEG input is read to linear
float32 via (v/255)^2.2; the writer encodes at quality 95 with the same
clamp/gamma/255.9-truncation as the PNG writer. Note the reference's
``save_jpeg`` is dead code (only --png/--exr outputs exist) and JPEG input
only works through --single (src/main.cpp:570-571, 648); we keep the same
surface for parity.

Backend: Pillow (libjpeg under the hood). The reference reader never sets
``data_layout`` (uninitialized field, SURVEY.md C14); we set RGB —
reproducing an uninitialized read is not meaningful in Python.
"""

from __future__ import annotations

import numpy as np

from .image import DataLayout, ImageBuffer
from .png import _DECODE_LUT, encode_rgba8

try:
    from PIL import Image as _PILImage

    _HAVE_PIL = True
except Exception:  # pragma: no cover
    _HAVE_PIL = False


def read_jpeg(path: str) -> ImageBuffer:
    if not _HAVE_PIL:
        raise RuntimeError("JPEG support requires Pillow (not available)")
    with _PILImage.open(path) as im:
        rgb = np.asarray(im.convert("RGB"), dtype=np.uint8)
    return ImageBuffer(data=np.ascontiguousarray(_DECODE_LUT[rgb]), layout=DataLayout.RGB)


def write_jpeg(path: str, img: np.ndarray, quality: int = 95) -> None:
    if not _HAVE_PIL:
        raise RuntimeError("JPEG support requires Pillow (not available)")
    rgb = encode_rgba8(img)[..., :3]
    _PILImage.fromarray(rgb, mode="RGB").save(path, format="JPEG", quality=quality)


def save_jpeg(path: str, img: ImageBuffer) -> None:
    write_jpeg(path, img.data)
