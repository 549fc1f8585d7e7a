"""Minimal OpenEXR scanline codec (HALF/FLOAT, none/ZIPS/ZIP compression).

Replaces the reference's OpenEXR dependency (src/image_formats.cpp:208-345)
with a self-contained numpy implementation of the subset of EXR 2.0 the
pipeline uses: single-part scanline images, HALF or FLOAT channels,
increasing-y line order, NO/ZIPS/ZIP compression.

Write path mirrors the reference exactly (src/image_formats.cpp:305-345):
channels named R, G, B, A, Z in *slot order* (first C of that list), HALF
precision, ZIP (16-scanline) compression at zlib level 9
(``header.zipCompressionLevel() = 9``, src/image_formats.cpp:332).

Read path mirrors src/image_formats.cpp:208-303: read ALL channels, detect
layout from the presence of "A"/"Z" channel names, map R->0, G->1, B->2 and
A/Z into slots 3/4 per layout; unknown channel names land in slot 0 (a
reference quirk — last writer wins — replicated for parity).

The EXR ZIP predictor+interleave transform is vectorized with numpy
(cumsum / diff), so multi-megapixel frames decode at memory speed; an
optional C++ fast path accelerates half<->float and reorder further.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from .image import DataLayout, ImageBuffer

MAGIC = 20000630
_PIXELTYPE_UINT = 0
_PIXELTYPE_HALF = 1
_PIXELTYPE_FLOAT = 2

_COMP_NONE = 0
_COMP_RLE = 1
_COMP_ZIPS = 2
_COMP_ZIP = 3

_SCANLINES_PER_BLOCK = {_COMP_NONE: 1, _COMP_ZIPS: 1, _COMP_ZIP: 16}

# Reference slot-order channel naming (src/image_formats.cpp:309).
SLOT_CHANNELS = ["R", "G", "B", "A", "Z"]


# --- EXR ZIP transform (predictor + two-half interleave) ---


def _zip_decompress(data: bytes, raw_size: int) -> np.ndarray:
    raw = zlib.decompress(data)
    buf = np.frombuffer(raw, dtype=np.uint8)
    if buf.size != raw_size:
        raise ValueError(f"EXR zip block: expected {raw_size} bytes, got {buf.size}")
    # Undo delta predictor: s[0]=d[0]; s[i] = s[i-1] + d[i] - 128 (mod 256).
    delta = buf.astype(np.int64)
    delta[1:] -= 128
    recon = np.cumsum(delta).astype(np.uint8)
    # Undo the even/odd split: first half -> even positions, second -> odd.
    out = np.empty(raw_size, dtype=np.uint8)
    half = (raw_size + 1) // 2
    out[0::2] = recon[:half]
    out[1::2] = recon[half:]
    return out


def _zip_compress(raw: np.ndarray, level: int = 9) -> bytes:
    n = raw.size
    half = (n + 1) // 2
    split = np.empty(n, dtype=np.uint8)
    split[:half] = raw[0::2]
    split[half:] = raw[1::2]
    # Delta predictor: d[0]=s[0]; d[i] = s[i] - s[i-1] + 128 (mod 256).
    d = split.astype(np.int64)
    d[1:] = d[1:] - d[:-1] + 128
    return zlib.compress(d.astype(np.uint8).tobytes(), level)


# --- header parsing ---


def _read_cstr(buf: bytes, off: int) -> Tuple[str, int]:
    end = buf.index(b"\x00", off)
    return buf[off:end].decode("latin-1"), end + 1


def _parse_channels(data: bytes) -> List[Tuple[str, int]]:
    """chlist attribute -> [(name, pixel_type), ...] in file order."""
    channels = []
    off = 0
    while data[off] != 0:
        name, off = _read_cstr(data, off)
        ptype, _plinear = struct.unpack_from("<iB", data, off)
        off += 16  # pixel type (4) + pLinear (1) + reserved (3) + xSampling (4) + ySampling (4)
        channels.append((name, ptype))
    return channels


def _encode_channels(channels: List[Tuple[str, int]]) -> bytes:
    out = bytearray()
    for name, ptype in channels:
        out += name.encode("latin-1") + b"\x00"
        out += struct.pack("<iBBBBii", ptype, 0, 0, 0, 0, 1, 1)
    out += b"\x00"
    return bytes(out)


class ExrHeader:
    def __init__(self):
        self.channels: List[Tuple[str, int]] = []
        self.compression = _COMP_ZIP
        self.data_window = (0, 0, 0, 0)  # xmin, ymin, xmax, ymax
        self.attrs: Dict[str, Tuple[str, bytes]] = {}

    @property
    def width(self) -> int:
        return self.data_window[2] - self.data_window[0] + 1

    @property
    def height(self) -> int:
        return self.data_window[3] - self.data_window[1] + 1


def _parse_header(buf: bytes) -> Tuple[ExrHeader, int]:
    magic, version = struct.unpack_from("<ii", buf, 0)
    if magic != MAGIC:
        raise ValueError("not an EXR file (bad magic)")
    if version & 0x200:
        raise ValueError("multi-part EXR not supported")
    if version & 0x800:
        raise ValueError("deep-data EXR not supported")
    if version & 0x400:
        raise ValueError("tiled EXR not supported")
    hdr = ExrHeader()
    off = 8
    while buf[off] != 0:
        name, off = _read_cstr(buf, off)
        atype, off = _read_cstr(buf, off)
        (size,) = struct.unpack_from("<i", buf, off)
        off += 4
        val = buf[off : off + size]
        off += size
        hdr.attrs[name] = (atype, val)
        if name == "channels":
            hdr.channels = _parse_channels(val)
        elif name == "compression":
            hdr.compression = val[0]
        elif name == "dataWindow":
            hdr.data_window = struct.unpack("<iiii", val)
    return hdr, off + 1


def _dtype_for(ptype: int):
    if ptype == _PIXELTYPE_HALF:
        return np.dtype("<f2")
    if ptype == _PIXELTYPE_FLOAT:
        return np.dtype("<f4")
    if ptype == _PIXELTYPE_UINT:
        return np.dtype("<u4")
    raise ValueError(f"unknown EXR pixel type {ptype}")


def _dst_slot_for(name: str, layout: "DataLayout") -> int:
    """Channel-name -> interleaved slot (src/image_formats.cpp:271-284).

    Unknown names land in slot 0 (reference quirk, last writer wins).
    """
    if name == "R":
        return 0
    if name == "G":
        return 1
    if name == "B":
        return 2
    if name == "A":
        return 3 if layout in (DataLayout.RGBA, DataLayout.RGBAZ) else 0
    if name == "Z":
        return {DataLayout.RGBZ: 3, DataLayout.RGBAZ: 4}.get(layout, 0)
    return 0


def _layout_for_names(names) -> "DataLayout":
    found_a = "A" in names
    found_z = "Z" in names
    if found_a and found_z:
        return DataLayout.RGBAZ
    if found_a:
        return DataLayout.RGBA
    if found_z:
        return DataLayout.RGBZ
    return DataLayout.RGB


def read_exr_channels(path: str) -> Tuple[Dict[str, np.ndarray], List[str]]:
    """Decode an EXR into {channel_name: (H, W) float32}, plus file order."""
    with open(path, "rb") as f:
        buf = f.read()
    hdr, off = _parse_header(buf)
    if hdr.compression not in _SCANLINES_PER_BLOCK:
        raise ValueError(f"EXR compression {hdr.compression} not supported (use none/ZIPS/ZIP)")

    w, h = hdr.width, hdr.height
    ymin = hdr.data_window[1]
    lines_per_block = _SCANLINES_PER_BLOCK[hdr.compression]
    n_blocks = (h + lines_per_block - 1) // lines_per_block

    # offset table: one uint64 per block
    offsets = struct.unpack_from(f"<{n_blocks}Q", buf, off)

    dtypes = [_dtype_for(pt) for _, pt in hdr.channels]
    bytes_per_line = sum(dt.itemsize for dt in dtypes) * w
    chans = {name: np.empty((h, w), dtype=np.float32) for name, _ in hdr.channels}

    for bi, boff in enumerate(offsets):
        if boff + 8 > len(buf):
            raise ValueError(f"EXR block {bi}: offset {boff} outside file")
        y, size = struct.unpack_from("<iI", buf, boff)
        if boff + 8 + size > len(buf):
            raise ValueError(f"EXR block {bi}: payload overruns file")
        # The block header is untrusted; an out-of-window y would index
        # rows outside the destination buffers.
        if y < ymin or y >= ymin + h:
            raise ValueError(f"EXR block {bi}: scanline y={y} outside data window")
        data = buf[boff + 8 : boff + 8 + size]
        block_lines = min(lines_per_block, ymin + h - y)
        raw_size = bytes_per_line * block_lines
        if (hdr.compression == _COMP_NONE or size == raw_size) and size < raw_size:
            raise ValueError(f"EXR block {bi}: short payload")
        if hdr.compression == _COMP_NONE or size == raw_size:
            raw = np.frombuffer(data, dtype=np.uint8)
        else:
            raw = _zip_decompress(data, raw_size)
        # Within a block: per scanline, per channel (file order), w values.
        pos = 0
        for ln in range(block_lines):
            row = y - ymin + ln
            for (name, _pt), dt in zip(hdr.channels, dtypes):
                nbytes = dt.itemsize * w
                vals = raw[pos : pos + nbytes].view(dt)
                chans[name][row] = vals.astype(np.float32)
                pos += nbytes
    return chans, [name for name, _ in hdr.channels]


def read_exr(path: str) -> ImageBuffer:
    """Read EXR -> interleaved float32 ImageBuffer.

    Layout detection and channel->slot mapping replicate
    src/image_formats.cpp:228-284 (incl. unknown names landing in slot 0).
    Uses the native C++ block decoder (parallel inflate + predictor +
    half->float + interleave) when available; numpy fallback otherwise.
    """
    native_result = _read_exr_native(path)
    if native_result is not None:
        return native_result

    chans, order = read_exr_channels(path)
    layout = _layout_for_names(chans)
    # Degenerate channel sets (e.g. Z without R/G/B) still map into the
    # layout's fixed slots; pad the buffer to the layout's slot count so
    # the mapping cannot index out of bounds (the C++ reads out of bounds
    # there, src/image_formats.cpp:249,278-284 — sanitized here, missing
    # slots are zero-filled; see docs/PARITY.md).
    n = max(len(order), layout.num_channels)
    h, w = next(iter(chans.values())).shape
    data = np.zeros((h, w, n), dtype=np.float32)
    for name in order:
        data[:, :, _dst_slot_for(name, layout)] = chans[name]
    return ImageBuffer(data=data, layout=layout)


def _read_exr_native(path: str) -> Optional[ImageBuffer]:
    """Native decode path; returns None when inapplicable (falls back)."""
    from ..utils import native

    if not native.available():
        return None
    with open(path, "rb") as f:
        buf = f.read()
    try:
        hdr, off = _parse_header(buf)
    except ValueError:
        return None
    if hdr.compression not in _SCANLINES_PER_BLOCK:
        return None
    if any(pt == _PIXELTYPE_UINT for _, pt in hdr.channels):
        return None
    w, h = hdr.width, hdr.height
    lines_per_block = _SCANLINES_PER_BLOCK[hdr.compression]
    n_blocks = (h + lines_per_block - 1) // lines_per_block
    offsets = np.frombuffer(buf, dtype="<u8", count=n_blocks, offset=off)
    names = [name for name, _ in hdr.channels]
    layout = _layout_for_names(names)
    dst_slots = np.asarray([_dst_slot_for(n_, layout) for n_ in names], dtype=np.int32)
    pixel_types = np.asarray([pt for _, pt in hdr.channels], dtype=np.int32)
    data = native.exr_decode(
        buf, offsets, hdr.compression, lines_per_block, w, h,
        hdr.data_window[1], pixel_types, dst_slots,
        max(len(names), layout.num_channels),
    )
    if data is None:
        return None
    return ImageBuffer(data=data, layout=layout)


def write_exr(
    path: str,
    img: np.ndarray,
    *,
    compression: str = "zip",
    level: int = 9,
    channel_names: Optional[List[str]] = None,
) -> None:
    """Write (H, W, C) float32 as HALF EXR, channels R,G,B,A,Z in slot order.

    Matches the reference writer (src/image_formats.cpp:305-345): HALF
    precision, ZIP/level 9 by default, at most 5 channels.
    """
    img = np.ascontiguousarray(img, dtype=np.float32)
    h, w, c = img.shape
    names = channel_names if channel_names is not None else SLOT_CHANNELS[:c]
    if c > len(SLOT_CHANNELS) and channel_names is None:
        raise ValueError("cannot save exr with more than 5 channels.")
    comp = {"none": _COMP_NONE, "zips": _COMP_ZIPS, "zip": _COMP_ZIP}[compression]
    lines_per_block = _SCANLINES_PER_BLOCK[comp]

    # EXR requires the channel list sorted by name; pixel data within each
    # scanline follows that sorted order.
    sort_idx = sorted(range(c), key=lambda i: names[i])
    sorted_names = [names[i] for i in sort_idx]

    header = bytearray()
    header += struct.pack("<ii", MAGIC, 2)

    def attr(name: str, atype: str, val: bytes):
        header.extend(name.encode() + b"\x00" + atype.encode() + b"\x00")
        header.extend(struct.pack("<i", len(val)))
        header.extend(val)

    attr("channels", "chlist", _encode_channels([(n_, _PIXELTYPE_HALF) for n_ in sorted_names]))
    attr("compression", "compression", bytes([comp]))
    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    attr("dataWindow", "box2i", box)
    attr("displayWindow", "box2i", box)
    attr("lineOrder", "lineOrder", b"\x00")
    attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
    attr("screenWindowCenter", "v2f", struct.pack("<ff", 0.0, 0.0))
    attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
    header += b"\x00"

    n_blocks = (h + lines_per_block - 1) // lines_per_block

    payloads = None
    if comp != _COMP_NONE:
        # Native parallel block encode (half conversion + predictor + deflate).
        from ..utils import native

        payloads = native.exr_encode_blocks(
            img, np.asarray(sort_idx, dtype=np.int32), lines_per_block, level
        )

    blocks = []
    if payloads is not None:
        for bi, payload in enumerate(payloads):
            blocks.append((bi * lines_per_block, payload))
    else:
        half = img.astype("<f2")  # f32 -> IEEE half, like the ref's f32->f16 pass
        for bi in range(n_blocks):
            y0 = bi * lines_per_block
            y1 = min(y0 + lines_per_block, h)
            # (lines, channels, w) in sorted-channel order -> raw bytes
            rows = half[y0:y1]  # (L, W, C)
            planar = np.ascontiguousarray(rows[:, :, sort_idx].transpose(0, 2, 1))
            raw = planar.view(np.uint8).reshape(-1)
            if comp == _COMP_NONE:
                payload = raw.tobytes()
            else:
                payload = _zip_compress(raw, level)
                if len(payload) >= raw.size:
                    payload = raw.tobytes()
            blocks.append((y0, payload))

    table_off = len(header) + 8 * n_blocks
    out = bytearray(header)
    pos = table_off
    for y0, payload in blocks:
        out += struct.pack("<Q", pos)
        pos += 8 + len(payload)
    for y0, payload in blocks:
        out += struct.pack("<iI", y0, len(payload))
        out += payload

    with open(path, "wb") as f:
        f.write(bytes(out))


def save_exr(path: str, img: ImageBuffer) -> None:
    if img.data.shape[2] > 5:
        raise ValueError("cannot save exr with more than 5 channels.")
    write_exr(path, img.data)
