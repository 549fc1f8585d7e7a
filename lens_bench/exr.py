"""Frozen OpenEXR scanline codec: HALF channels, ZIP (16 lines) or none.

The benchmark writes its EXR inputs and reads back the program's EXR
outputs with this copy, so that what a cell judges does not rest on the
program's own codec. The subset is what image-lens-reproject writes
(src/image_formats.cpp:305-345): one part, scanlines, increasing y,
channels R, G, B (A, Z) in slot order and stored sorted by name, ZIP with
the EXR predictor and the two-half interleave; a block stored raw when
compression would not shrink it. Blocks are compressed and inflated on a
thread pool (zlib releases the interpreter lock).
"""

from __future__ import annotations

import struct
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

MAGIC = 20000630
HALF = 1
FLOAT = 2
NO_COMPRESSION = 0
ZIP = 3
LINES = {NO_COMPRESSION: 1, ZIP: 16}
SLOTS = ("R", "G", "B", "A", "Z")


def _pack(raw: np.ndarray, level: int) -> bytes:
    half = (raw.size + 1) // 2
    split = np.empty(raw.size, dtype=np.uint8)
    split[:half] = raw[0::2]
    split[half:] = raw[1::2]
    d = split.astype(np.int16)
    d[1:] = d[1:] - d[:-1] + 128
    return zlib.compress(d.astype(np.uint8).tobytes(), level)


def _unpack(data: bytes, raw_size: int) -> np.ndarray:
    buf = np.frombuffer(zlib.decompress(data), dtype=np.uint8)
    if buf.size != raw_size:
        raise ValueError(f"EXR block: {buf.size} bytes, expected {raw_size}")
    d = buf.astype(np.int64)
    d[1:] -= 128
    recon = np.cumsum(d).astype(np.uint8)
    out = np.empty(raw_size, dtype=np.uint8)
    half = (raw_size + 1) // 2
    out[0::2] = recon[:half]
    out[1::2] = recon[half:]
    return out


def _attr(name: str, kind: str, value: bytes) -> bytes:
    return name.encode() + b"\0" + kind.encode() + b"\0" + struct.pack("<i", len(value)) + value


def write(path: str, img: np.ndarray, *, level: int = 1, threads: int = 8) -> int:
    """Writes (H, W, C) values as HALF EXR, ZIP at zlib ``level``; returns
    the bytes written."""
    half = np.ascontiguousarray(img).astype("<f2")
    h, w, c = half.shape
    names = SLOTS[:c]
    order = sorted(range(c), key=lambda i: names[i])
    chlist = b"".join(names[i].encode() + b"\0" + struct.pack("<iBBBBii", HALF, 0, 0, 0, 0, 1, 1)
                      for i in order) + b"\0"
    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header = (struct.pack("<ii", MAGIC, 2) + _attr("channels", "chlist", chlist)
              + _attr("compression", "compression", bytes([ZIP]))
              + _attr("dataWindow", "box2i", box) + _attr("displayWindow", "box2i", box)
              + _attr("lineOrder", "lineOrder", b"\0")
              + _attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
              + _attr("screenWindowCenter", "v2f", struct.pack("<ff", 0.0, 0.0))
              + _attr("screenWindowWidth", "float", struct.pack("<f", 1.0)) + b"\0")
    lines = LINES[ZIP]

    def block(y0: int) -> bytes:
        planar = np.ascontiguousarray(half[y0:y0 + lines][:, :, order].transpose(0, 2, 1))
        raw = planar.view(np.uint8).reshape(-1)
        packed = _pack(raw, level)
        return packed if len(packed) < raw.size else raw.tobytes()

    with ThreadPoolExecutor(max_workers=threads) as pool:
        payloads = list(pool.map(block, range(0, h, lines)))
    pos = len(header) + 8 * len(payloads)
    table = bytearray()
    for p in payloads:
        table += struct.pack("<Q", pos)
        pos += 8 + len(p)
    with open(path, "wb") as f:
        f.write(header)
        f.write(table)
        for i, p in enumerate(payloads):
            f.write(struct.pack("<iI", i * lines, len(p)))
            f.write(p)
    return pos


def _cstr(buf: bytes, off: int):
    end = buf.index(b"\0", off)
    return buf[off:end].decode("latin-1"), end + 1


def read(path: str, *, threads: int = 8) -> np.ndarray:
    """(H, W, C) float32 of an EXR as ``write`` and the program write it:
    HALF or FLOAT channels, channels put in slot order R, G, B, A, Z."""
    with open(path, "rb") as f:
        buf = f.read()
    magic, version = struct.unpack_from("<ii", buf, 0)
    if magic != MAGIC or version & 0xE00:
        raise ValueError(f"{path}: not a single-part scanline EXR")
    off, channels, comp, window = 8, [], None, None
    while buf[off] != 0:
        name, off = _cstr(buf, off)
        _kind, off = _cstr(buf, off)
        (size,) = struct.unpack_from("<i", buf, off)
        value = buf[off + 4:off + 4 + size]
        off += 4 + size
        if name == "channels":
            p = 0
            while value[p] != 0:
                cname, p = _cstr(value, p)
                channels.append((cname, struct.unpack_from("<i", value, p)[0]))
                p += 16
        elif name == "compression":
            comp = value[0]
        elif name == "dataWindow":
            window = struct.unpack("<iiii", value)
    off += 1
    if comp not in LINES or window is None:
        raise ValueError(f"{path}: compression {comp} or data window not supported")
    if any(pt not in (HALF, FLOAT) for _, pt in channels):
        raise ValueError(f"{path}: only HALF and FLOAT channels are read")
    w, h, y_min = window[2] - window[0] + 1, window[3] - window[1] + 1, window[1]
    lines = LINES[comp]
    n_blocks = (h + lines - 1) // lines
    offsets = struct.unpack_from(f"<{n_blocks}Q", buf, off)
    dtypes = [np.dtype("<f2") if pt == HALF else np.dtype("<f4") for _, pt in channels]
    line_bytes = w * sum(dt.itemsize for dt in dtypes)
    slot = {n: i for i, n in enumerate(SLOTS)}
    out = np.zeros((h, w, max(len(channels), 1 + max(slot.get(n, 0) for n, _ in channels))),
                   dtype=np.float32)

    def block(b: int) -> None:
        y, size = struct.unpack_from("<iI", buf, offsets[b])
        if not y_min <= y < y_min + h:
            raise ValueError(f"{path}: block {b} starts at line {y}, outside the data window")
        n_lines = min(lines, y_min + h - y)
        raw_size = line_bytes * n_lines
        data = buf[offsets[b] + 8:offsets[b] + 8 + size]
        raw = (np.frombuffer(data, dtype=np.uint8) if size == raw_size
               else _unpack(data, raw_size))
        pos = 0
        for ln in range(n_lines):
            for (cname, _), dt in zip(channels, dtypes):
                n = dt.itemsize * w
                out[y - y_min + ln, :, slot.get(cname, 0)] = raw[pos:pos + n].view(dt)
                pos += n

    with ThreadPoolExecutor(max_workers=threads) as pool:
        list(pool.map(block, range(n_blocks)))
    return out
