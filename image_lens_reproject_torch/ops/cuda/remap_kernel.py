"""Wrapper of kernel B1 (``csrc/remap_kernel.cu``): fused remap + tonemap.

B1 covers every combination the JAX package's K1 accepts: any of the five
lenses on either side (rectilinear, equidistant, equisolid, stereographic,
equirectangular, full or partial), nearest, bilinear or bicubic sampling,
any supersample count, channel count, rotation and tonemap.

Two entry points, each with its plain PyTorch version beside it:

- ``remap_tonemap`` takes a ``(B, H, W, C)`` float32 batch and returns the
  whole output frame, or a band of its rows (``row_offset`` /
  ``row_count``: K1's ``row0`` / ``band_rows``, the unit of the mesh's rows
  axis in ``parallel/batch.py``); given a ``(V, 3, 3)`` rotation stack, the
  view axis, it returns ``(B, V, out_h, out_w, C)``, every view of the
  full frame in one launch of B1's view mode (``blockIdx.z`` the view);
- ``remap_tonemap_list`` (B1's list mode) writes only the listed 8 x 128
  output sub-tiles of an existing output, in place: of the frame, or of a
  band of its rows (the direct sub-tiles of a mesh band's plan).

A CPU tensor goes to the plain version (``ops/remap.py`` then
``ops/color.py``). A CUDA tensor launches B1 or raises: there is no
fallback. Both launch in the mode that ``launch_mode`` picks, counted in
``build.COUNTS`` under its name: ``b1.frame``, ``b1.band``, ``b1.list``,
``b1.list_band``, ``b1.views`` (their views in ``b1.views_computed``);
a frame or band that fills, reads or bypasses a coordinate field also
in ``b1.field_fill``, ``b1.field_hit`` or ``b1.field_bypass``.

A rotation the caller holds on the host (numpy, a sequence, a CPU tensor)
reaches the kernel by value, as nine float32 in the launch constants, so a
call queues no copy and never waits for the card; a CUDA tensor goes by
its pointer, as reading it here would wait for the card. A stack goes the
same way (``launch_setup``). Band mode, list mode and B2 refuse a stack.

The coordinate field. A pixel's source coordinate (sx, sy) depends only on
the lenses' float32 constants, the sizes, the band of rows and the
rotation's float32 bits, never on the frame, and a video pipeline calls
with the same configuration frame after frame. So ``remap_tonemap``'s
frame and band calls keep, per configuration, a field of (sx, sy) as
float32 pairs: 8 bytes an output pixel (66 MB at a 3840 x 2160 output).
The first call of a configuration (``field_key``: those launch constants,
the device and the current stream) launches B1 as ever and remembers the
key; the second fills the field with B1's own coordinate arithmetic
(``coord_field`` in ``csrc/remap_frame.cu``) and samples from it; every
later one only samples (B1's read instances: the same float32 values, so
the same output bit for bit). A caller whose rotation changes every call
never pays for a fill. Fields live in ``FIELDS``, least recently used
first out, under ``FIELD_CACHE_BYTES`` (1 GiB) of device memory; a field
larger than that is never made. A field serves only the stream that filled it,
which is part of its key, so the caching allocator's stream order holds.
List mode, view mode, kernel B2, n x n supersampling, a rotation on the
card (its key would need its values, a wait for the card), a call made
while a CUDA graph captures and the CPU's plain path use no field
(``launch_mode``).

While a torch profiler runs (``utils/tracing.profiling``), a CUDA call of
either entry point records the spans ``b1.wrapper`` (the whole call, a
profiler range), and inside it, with no range of their own
(``tracing.QuietSpan``), ``b1.rotation`` (the rotation's handling: a
host rotation rounded to float32, a CUDA one checked), ``b1.views`` (view
mode's stack, handled the same way), ``b1.params`` (the
launch constants), ``b1.field`` (a frame or band call that may use a
field: its key and the cache's answer) and ``b1.launch`` (the output's
allocation, the ctypes calls and their checks); with none, a call checks
one flag and enters no-op spans.
"""

from __future__ import annotations

import ctypes
import functools
import operator
import threading
from collections import OrderedDict
from typing import Optional, Tuple

import numpy as np
import torch

from ...models.lens import (
    Equirectangular,
    FisheyeEquidistant,
    FisheyeEquisolid,
    FisheyeStereographic,
    LensSpec,
    Rectilinear,
    wrap_mode_for_input,
)
from ...utils import tracing
from .. import color, remap
from . import build

LIBRARY = "ilr_remap"
# The entry points, and the kernel (full frame, its views, list mode)
# compiled once for each input lens (its LensCode), all at once (build.py).
SOURCES = ("remap_kernel.cu",) + tuple(
    ("remap_frame.cu", (f"ILR_IN_LENS={code}",)) for code in range(5))
_MAX_BATCH = 65535  # gridDim.y of kernel B2, which shares these checks

# Mirrored by kMaxOffsets, kAnyChannels, kAnySamples and kMaxViewsByValue in
# csrc/remap_device.cuh.
MAX_OFFSETS = 16
MAX_VIEWS_BY_VALUE = 16
# gridDim.z: the views of one launch.
_MAX_VIEWS = 65535
ANY_CHANNELS = 0
ANY_SAMPLES = 0
# Offsets inside one image are 32-bit in the C = 3 and C = 4 instances.
_OFFSET_LIMIT = 2**31
# A band's rows are int32 in the kernel.
_ROW_LIMIT = 2**31 - 1

# Mirrored by the LensCode and InterpCode enums of csrc/remap_device.cuh.
LENS_CODES = {
    Rectilinear: 0,
    FisheyeEquidistant: 1,
    FisheyeEquisolid: 2,
    FisheyeStereographic: 3,
    Equirectangular: 4,
}
INTERP_CODES = {"nearest": 0, "bilinear": 1, "bicubic": 2}
# Mirrored by the RotationCode enum of csrc/remap_device.cuh (RemapParams.has_rotation).
NO_ROTATION, ROTATION_BY_VALUE, ROTATION_ON_DEVICE = 0, 1, 2
# Device memory the coordinate fields of a process may hold in all: 16
# fields of a 3840 x 2160 output, 4 of an 8K one.
FIELD_CACHE_BYTES = 1 << 30
# Configurations remembered after their first call, most recent kept.
FIELD_SEEN_KEYS = 64


class RemapParams(ctypes.Structure):
    """Mirror of ``struct RemapParams`` in csrc/remap_device.cuh, field for field."""

    _fields_ = [
        (name, ctypes.c_int32)
        for name in (
            "batch", "in_h", "in_w", "channels", "out_h", "out_w",
            "n_samples", "wrap", "has_rotation", "tonemap",
            "out_lens", "in_lens", "interp",
        )
    ] + [
        (name, ctypes.c_float)
        for name in (
            "out_half_w", "out_half_h", "in_half_w", "in_half_h",
            "normalize", "exposure", "inv_max2",
        )
    ] + [
        ("out_k", ctypes.c_float * 6), ("in_k", ctypes.c_float * 6),
        ("offsets", ctypes.c_float * MAX_OFFSETS),
        ("spec_channels", ctypes.c_int32), ("spec_samples", ctypes.c_int32),
        ("row0", ctypes.c_int32), ("band_rows", ctypes.c_int32),
        ("rotation", ctypes.c_float * (9 * MAX_VIEWS_BY_VALUE)),
    ]


_P, _I, _PARAMS = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(RemapParams)
# The entry points of csrc/remap_kernel.cu, each argument's type in the
# order of its C definition there (build.bind).
SIGNATURES = {
    "ilr_remap_frame": [_P, _P, _P, _PARAMS, _I, _P],
    "ilr_remap_list": [_P, _P, _P, _P, _I, _PARAMS, _I, _P],
    "ilr_remap_views": [_P, _P, _P, _I, _PARAMS, _I, _P],
    "ilr_coord_field": [_P, _PARAMS, _I, _P],
    "ilr_remap_field": [_P, _P, _P, _PARAMS, _I, _P],
    "ilr_params_size": [],
}


def _f32(v: float) -> float:
    return float(np.float32(v))


def out_constants(lens: LensSpec, w: float, h: float):
    """The output lens's pixel -> ray constants (``to_vec`` in the .cu).

    Each is ``_f32`` of the double expression of ``models/projections.py``.
    """
    if isinstance(lens, Rectilinear):
        k = (lens.sensor_width / (w * lens.focal_length),
             lens.sensor_height / (h * lens.focal_length))
    elif isinstance(lens, FisheyeEquidistant):
        k = (lens.fov / w,)
    elif isinstance(lens, (FisheyeEquisolid, FisheyeStereographic)):
        k = (lens.sensor_width / w, 1.0 / (2.0 * lens.focal_length),
             lens.sensor_width / (lens.focal_length * w))
    else:
        k = (1.0 / w, lens.longitude_span, lens.longitude_min,
             1.0 / h, lens.latitude_span, lens.latitude_min)
    return tuple(_f32(v) for v in k) + (0.0,) * (6 - len(k))


def in_constants(lens: LensSpec, w: float, h: float):
    """The input lens's ray -> pixel constants (``to_source`` in the .cu)."""
    if isinstance(lens, Rectilinear):
        k = (w * lens.focal_length / lens.sensor_width,
             h * lens.focal_length / lens.sensor_height)
    elif isinstance(lens, FisheyeEquidistant):
        k = (w / lens.fov,)
    elif isinstance(lens, (FisheyeEquisolid, FisheyeStereographic)):
        k = (2.0 * lens.focal_length, w / lens.sensor_width,
             lens.focal_length * w / lens.sensor_width)
    else:
        k = (lens.longitude_min, 1.0 / lens.longitude_span, w,
             lens.latitude_min, 1.0 / lens.latitude_span, h)
    return tuple(_f32(v) for v in k) + (0.0,) * (6 - len(k))


def rotation_code(rotation) -> int:
    """How ``rotation`` reaches the kernel (``RemapParams.has_rotation``).

    ``NO_ROTATION`` for None; ``ROTATION_ON_DEVICE`` for a tensor on a
    device, whose pointer the kernel reads; ``ROTATION_BY_VALUE`` for a
    rotation on the host (numpy, a sequence, a CPU tensor).
    """
    if rotation is None:
        return NO_ROTATION
    if isinstance(rotation, torch.Tensor) and rotation.device.type != "cpu":
        return ROTATION_ON_DEVICE
    return ROTATION_BY_VALUE


def host_rotation(rotation) -> np.ndarray:
    """A host rotation as the contiguous (3, 3) float32 the kernel reads by value.

    Rounded as ``torch.as_tensor(rotation, dtype=torch.float32)`` rounds
    it, with no tensor on a device made. Raises ``ValueError`` for another
    shape.
    """
    if isinstance(rotation, torch.Tensor):
        rotation = rotation.detach().to(torch.float32).numpy()
    r = np.ascontiguousarray(rotation, dtype=np.float32)
    if r.shape != (3, 3):
        raise ValueError(f"rotation must be (3, 3), got {tuple(r.shape)}")
    return r


def host_rotations(stack) -> np.ndarray:
    """A host ``(V, 3, 3)`` stack as the contiguous float32 the kernel reads
    by value, rounded as ``host_rotation`` rounds one rotation."""
    if isinstance(stack, torch.Tensor):
        stack = stack.detach().to(torch.float32).numpy()
    r = np.ascontiguousarray(stack, dtype=np.float32)
    if remap.view_count(r) is None:
        raise ValueError(f"a rotation stack must be (V, 3, 3), got {r.shape}")
    return r


def uncovered(in_lens: LensSpec, out_lens: LensSpec, interp: str) -> Optional[str]:
    """Why B1 cannot run this combination, or None when it can."""
    for side, lens in (("input", in_lens), ("output", out_lens)):
        if type(lens) not in LENS_CODES:
            return f"{side} lens {type(lens).__name__}: kernel B1 has no projection for it"
    if interp not in INTERP_CODES:
        return f"interp={interp!r}: kernel B1 samples {', '.join(INTERP_CODES)}"
    return None


def remap_tonemap_plain(
    batch: torch.Tensor,
    rotation,
    *,
    in_lens: LensSpec,
    out_lens: LensSpec,
    out_h: int,
    out_w: int,
    interp: str = "bicubic",
    n_samples: int = 1,
    exposure: float = 1.0,
    reinhard: float = 1.0,
    row_offset: int = 0,
    row_count: Optional[int] = None,
) -> torch.Tensor:
    """The plain PyTorch version of B1, on whatever device ``batch`` lies."""
    out = remap.remap_batch(
        batch, rotation, in_lens=in_lens, out_lens=out_lens,
        out_h=out_h, out_w=out_w, interp=interp, n_samples=n_samples,
        row_offset=row_offset, row_count=row_count,
    )
    if color.needed(exposure, reinhard):
        out = color.post_process(out, exposure, reinhard)
    return out


def remap_tonemap_list_plain(
    batch: torch.Tensor,
    rotation,
    out: torch.Tensor,
    tiles: torch.Tensor,
    *,
    in_lens: LensSpec,
    out_lens: LensSpec,
    out_h: int,
    out_w: int,
    interp: str = "bicubic",
    n_samples: int = 1,
    exposure: float = 1.0,
    reinhard: float = 1.0,
    row_offset: int = 0,
    row_count: Optional[int] = None,
) -> torch.Tensor:
    """The plain version of B1's list mode: ``out`` at ``tiles`` only, in place.

    ``tiles`` is an ``(n, 2)`` integer tensor of (sub-tile row, sub-tile
    column) on 8 x 128 output sub-tiles of the band of rows
    ``[row_offset, row_offset + row_count)`` (by default the whole frame),
    the rows counted from the band's first; ``out`` holds the band's rows.
    The pixels are computed on the pixel centres of those sub-tiles only
    (``remap.remap_subtiles``).
    """
    row_offset, _ = remap.check_band(row_offset, row_count, out_h)
    vals = remap.remap_subtiles(
        batch, rotation, tiles, in_lens=in_lens, out_lens=out_lens,
        out_h=out_h, out_w=out_w, interp=interp, n_samples=n_samples, row_offset=row_offset,
    )
    if color.needed(exposure, reinhard):
        vals = color.post_process(vals, exposure, reinhard)
    remap.scatter_subtiles(out, vals, tiles)
    return out


@functools.cache
def library() -> ctypes.CDLL:
    """B1's shared library, built from ``csrc/`` by nvcc at the first call."""
    return build.check_params(build.bind(build.load(LIBRARY, SOURCES), SIGNATURES), RemapParams)


def specialisation(batch_shape, n_samples: int, aligned: bool):
    """(channels, samples): B1's instance for these shapes, full frame and list mode.

    ``channels`` is C when C is 3, or 4 with a 16-byte aligned source
    (``aligned``: one 16-byte load a tap), and the image has fewer than
    2**31 values, so that offsets inside it fit 32 bits; else
    ``ANY_CHANNELS`` (64-bit offsets). ``samples`` is 1 for one supersample,
    else ``ANY_SAMPLES``.
    """
    _, in_h, in_w, c = (int(d) for d in batch_shape)
    fits = in_h * in_w * c < _OFFSET_LIMIT
    channels = c if fits and (c == 3 or (c == 4 and aligned)) else ANY_CHANNELS
    return channels, 1 if n_samples == 1 else ANY_SAMPLES


def params(
    batch_shape, *, in_lens: LensSpec, out_lens: LensSpec, out_h: int, out_w: int,
    interp: str, n_samples: int, exposure: float, reinhard: float, rotation,
    aligned: bool, row_offset: int = 0, row_count: Optional[int] = None,
) -> RemapParams:
    """B1's launch constants, each float rounded once to float32 from double.

    ``rotation``: None, a host rotation (carried by value, ``host_rotation``)
    or a tensor on a device (``has_rotation`` only: the launch passes its
    pointer); ``rotation_code`` tells which. ``aligned``: whether the
    source's address is a multiple of 16 bytes.
    ``row_offset`` / ``row_count``: the band of output rows a launch
    computes (the defaults: all ``out_h``), the full frame's, list mode's
    or kernel B2's: the output holds the band's rows, and list entries
    count their sub-tile rows from its first.
    """
    b, in_h, in_w, c = (int(d) for d in batch_shape)
    row0, band_rows = remap.check_band(row_offset, row_count, out_h)
    if row0 + band_rows > _ROW_LIMIT:
        raise ValueError(f"band rows [{row0}, {row0 + band_rows}) do not fit int32")
    offsets = remap.supersample_offsets(n_samples)[:MAX_OFFSETS]
    spec_channels, spec_samples = specialisation(batch_shape, n_samples, aligned)
    code = rotation_code(rotation)
    p = RemapParams(
        batch=b, in_h=in_h, in_w=in_w, channels=c, out_h=out_h, out_w=out_w,
        n_samples=n_samples, wrap=int(wrap_mode_for_input(in_lens)),
        has_rotation=code, tonemap=int(color.needed(exposure, reinhard)),
        out_lens=LENS_CODES[type(out_lens)], in_lens=LENS_CODES[type(in_lens)],
        interp=INTERP_CODES[interp],
        out_half_w=_f32(out_w * 0.5), out_half_h=_f32(out_h * 0.5),
        in_half_w=_f32(in_w * 0.5), in_half_h=_f32(in_h * 0.5),
        normalize=_f32(1.0 / (n_samples * n_samples)),
        exposure=_f32(exposure), inv_max2=_f32(1.0 / (reinhard * reinhard)),
        out_k=(ctypes.c_float * 6)(*out_constants(out_lens, float(out_w), float(out_h))),
        in_k=(ctypes.c_float * 6)(*in_constants(in_lens, float(in_w), float(in_h))),
        offsets=(ctypes.c_float * MAX_OFFSETS)(*offsets),
        spec_channels=spec_channels, spec_samples=spec_samples,
        row0=row0, band_rows=band_rows,
    )
    if code == ROTATION_BY_VALUE:
        set_rotations(p, host_rotation(rotation))
    return p


def set_rotations(p: RemapParams, rotations: np.ndarray) -> None:
    """Puts contiguous float32 rotations, (3, 3) or a (V, 3, 3) stack of at
    most ``MAX_VIEWS_BY_VALUE``, at the start of ``p.rotation``. (A copy
    from the array's bytes: ``rotations.ctypes`` alone costs a call ~2 µs
    of host time, and every call with a host rotation takes this path.)"""
    if rotations.nbytes > RemapParams.rotation.size:
        raise ValueError(f"{rotations.nbytes // 36} rotations do not fit RemapParams")
    ctypes.memmove(ctypes.addressof(p) + RemapParams.rotation.offset, rotations.tobytes(),
                   rotations.nbytes)


def launch_setup(name: str, batch: torch.Tensor, rotation, *, in_lens, out_lens, out_h, out_w,
                 interp, n_samples, exposure, reinhard, row_offset=0, row_count=None,
                 views: Optional[int] = None, spans: bool = False):
    """Checks a CUDA batch and the combination; returns (params, the
    rotation's device tensor or None, stream).

    Raises on what the kernels do not take: another device or dtype, a
    non-contiguous or badly shaped batch or rotation, or an uncovered
    combination. A host rotation goes into the params by value and a tensor
    on a device stays there (``rotation_code``), counted in
    ``b1.rotation_by_value`` and ``b1.rotation_on_device``. ``views``: the
    view count of a ``(V, 3, 3)`` rotation stack (the full frame's view
    axis), by value up to ``MAX_VIEWS_BY_VALUE`` views from the host, else
    through a pointer (a larger host stack copied to the card first); None
    refuses a stack. ``spans``: B1's ``b1.rotation``, ``b1.params`` and
    ``b1.views`` spans.
    """
    if not batch.is_cuda:
        raise ValueError(f"{name}: unsupported device {batch.device}")
    if views is None:
        remap.refuse_views(rotation, name)
    else:
        remap.frame_views(rotation, row_offset, row_count, out_h)
        if views > _MAX_VIEWS:
            raise ValueError(f"{name}: at most {_MAX_VIEWS} views a call, got {views}")
    why = uncovered(in_lens, out_lens, interp)
    if why is not None:
        raise ValueError(f"{name}: {why}")
    if batch.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {batch.dtype}")
    if batch.ndim != 4 or not batch.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous (B, H, W, C) tensor, "
                         f"got shape {tuple(batch.shape)}")
    b, in_h, in_w, c = (int(d) for d in batch.shape)
    if in_h < 2 or in_w < 2 or c < 1 or not 1 <= b <= _MAX_BATCH:
        raise ValueError(f"{name}: unsupported batch shape {tuple(batch.shape)}")
    if out_h < 1 or out_w < 1 or n_samples < 1:
        raise ValueError(f"{name}: bad out_h={out_h}, out_w={out_w} or n_samples={n_samples}")
    with tracing.QuietSpan("b1.rotation") if spans else tracing.OFF:
        code = NO_ROTATION if views is not None else rotation_code(rotation)
        if code == ROTATION_ON_DEVICE:
            rot = remap.rotation_tensor(rotation, batch.device).contiguous()
        elif code == ROTATION_BY_VALUE:
            rot = host_rotation(rotation)
        else:
            rot = None
    with tracing.QuietSpan("b1.params") if spans else tracing.OFF:
        p = params(batch.shape, in_lens=in_lens, out_lens=out_lens, out_h=out_h, out_w=out_w,
                   interp=interp, n_samples=n_samples, exposure=exposure, reinhard=reinhard,
                   rotation=rot, aligned=batch.data_ptr() % 16 == 0,
                   row_offset=row_offset, row_count=row_count)
    if views is not None:
        with tracing.QuietSpan("b1.views") if spans else tracing.OFF:
            if rotation_code(rotation) == ROTATION_ON_DEVICE:
                rot = rotation.to(torch.float32).contiguous()
            else:
                host = host_rotations(rotation)
                if views <= MAX_VIEWS_BY_VALUE:
                    set_rotations(p, host)
                else:
                    rot = torch.from_numpy(host).to(batch.device)
            p.has_rotation = ROTATION_BY_VALUE if rot is None else ROTATION_ON_DEVICE
    elif code == ROTATION_ON_DEVICE:
        _COUNTS["b1.rotation_on_device"] += 1
    elif code == ROTATION_BY_VALUE:
        _COUNTS["b1.rotation_by_value"] += 1
        rot = None
    return p, rot, torch.cuda.current_stream(batch.device).cuda_stream


def check_output(name: str, out: torch.Tensor, batch: torch.Tensor, p: RemapParams):
    """An in-place output must be the batch's (B, band_rows, out_w, C)
    float32 on its device, for the band of ``p`` (all out_h by default)."""
    want = (int(batch.shape[0]), p.band_rows, p.out_w, int(batch.shape[3]))
    if (tuple(out.shape) != want or out.dtype != torch.float32 or out.device != batch.device
            or not out.is_contiguous()):
        raise ValueError(f"{name}: output must be a contiguous float32 {want} tensor on "
                         f"{batch.device}, got {out.dtype} {tuple(out.shape)} on {out.device}")


def check_list(name: str, entries: torch.Tensor, batch: torch.Tensor, width: int):
    if (entries.ndim != 2 or entries.shape[1] != width or entries.dtype != torch.int32
            or entries.device != batch.device or not entries.is_contiguous()):
        raise ValueError(f"{name}: expected a contiguous (n, {width}) int32 list on "
                         f"{batch.device}, got {entries.dtype} {tuple(entries.shape)} "
                         f"on {entries.device}")


def _byte_ranges(*spans) -> Tuple[Tuple[int, int], ...]:
    """(start, stop) byte ranges of RemapParams, for (field name, bytes or
    None for the whole field) pairs, touching ranges merged."""
    ranges = sorted((getattr(RemapParams, name).offset,
                     getattr(RemapParams, name).offset + (n or getattr(RemapParams, name).size))
                    for name, n in spans)
    merged = [list(ranges[0])]
    for a, b in ranges[1:]:
        if a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return tuple((a, b) for a, b in merged)


# What source_coord and pixel_centre read of the launch constants, and the
# band's size: a field's values are a function of these bytes alone.
FIELD_RANGES = _byte_ranges(
    ("out_lens", None), ("in_lens", None), ("out_k", None), ("in_k", None),
    ("out_half_w", None), ("out_half_h", None), ("in_half_w", None), ("in_half_h", None),
    ("out_w", None), ("out_h", None), ("row0", None), ("band_rows", None),
    ("has_rotation", None), ("offsets", 4), ("rotation", 36),
)
_field_bytes = operator.itemgetter(*(slice(a, b) for a, b in FIELD_RANGES))


def field_key(p: RemapParams, device: torch.device, stream: int) -> tuple:
    """The coordinate field's key of a frame or band launch: the bytes of
    ``p`` that a pixel's source coordinate depends on (the lenses, their
    float32 constants, the sizes, the band, the first supersample offset
    and the rotation by value), the device and the stream."""
    return device, stream, _field_bytes(bytes(p))


# B1's launches (``launch_mode``), each also its key in ``build.COUNTS``; a
# field's fill, read or bypass counts there as a frame or band as well.
FRAME, BAND, VIEWS, LIST, LIST_BAND = "b1.frame", "b1.band", "b1.views", "b1.list", "b1.list_band"
FIELD_FILL, FIELD_READ, FIELD_BYPASS = "b1.field_fill", "b1.field_hit", "b1.field_bypass"
_FIELD_MODES = frozenset((FIELD_FILL, FIELD_READ, FIELD_BYPASS))
_COUNTS = build.counters(FRAME, BAND, VIEWS, LIST, LIST_BAND, FIELD_FILL, FIELD_READ,
                         FIELD_BYPASS, "b1.views_computed", "b1.rotation_by_value",
                         "b1.rotation_on_device")


class FieldCache:
    """Coordinate fields by ``field_key``, least recently used evicted first
    to keep their bytes within ``cap_bytes``, and the keys seen once (the
    last ``seen_keys`` of them). Safe to share between threads.

    A key seen once is remembered by its hash, an int, so that a caller
    whose configuration changes every call leaves no object behind for the
    garbage collector to track; two keys of one hash only make the second
    fill at its first call."""

    def __init__(self, cap_bytes: int = FIELD_CACHE_BYTES, seen_keys: int = FIELD_SEEN_KEYS):
        self.cap_bytes, self.seen_keys = cap_bytes, seen_keys
        self.bytes = 0
        self._fields: "OrderedDict[tuple, torch.Tensor]" = OrderedDict()
        self._seen: "OrderedDict[int, None]" = OrderedDict()
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self._fields)

    def lookup(self, key: tuple, nbytes: int) -> Tuple[Optional[torch.Tensor], str]:
        """The cache's answer for ``key``, whose field takes ``nbytes``:
        (its field, now the most recently used, ``FIELD_READ``); else
        (None, ``FIELD_FILL``) for a key seen once before, now forgotten, to
        be filled, or (None, ``FIELD_BYPASS``) for a new key, now
        remembered, and for a field over the cap, never made."""
        with self._lock:
            field = self._fields.get(key)
            if field is not None:
                self._fields.move_to_end(key)
                return field, FIELD_READ
            seen, h = self._seen, hash(key)
            if h in seen:
                del seen[h]
                return None, FIELD_FILL if nbytes <= self.cap_bytes else FIELD_BYPASS
            seen[h] = None
            if len(seen) > self.seen_keys:
                seen.popitem(last=False)
            return None, FIELD_BYPASS

    def put(self, key: tuple, field: torch.Tensor) -> None:
        """Keeps ``field`` under ``key``, the least recently used fields
        dropped until the bytes fit the cap."""
        n = field.numel() * field.element_size()
        with self._lock:
            old = self._fields.pop(key, None)
            if old is not None:
                self.bytes -= old.numel() * old.element_size()
            while self._fields and self.bytes + n > self.cap_bytes:
                _, gone = self._fields.popitem(last=False)
                self.bytes -= gone.numel() * gone.element_size()
            self._fields[key] = field
            self.bytes += n


FIELDS = FieldCache()


def launch_mode(views: Optional[int], listed: bool, band: bool, n_samples: int, rotation: int,
                capturing: bool = False, cached: Optional[str] = None) -> str:
    """B1's launch for a CUDA call, from what it was given: ``views``, the
    view count of a rotation stack or None; ``listed``, list mode; ``band``,
    rows other than the full frame's; ``rotation``, its ``rotation_code``;
    ``capturing``, whether a CUDA graph captures on its stream; ``cached``,
    the field cache's answer (``FieldCache.lookup``), None if not asked.

    A frame or band of one supersample whose rotation is not on the card
    reads, fills or bypasses its coordinate field as the cache answers,
    but while a graph captures a read or a fill launches B1 as ever (a
    field filled there holds nothing until a replay, and one read there
    could be evicted before one).
    """
    if views is not None:
        return VIEWS
    if listed:
        return LIST_BAND if band else LIST
    if (cached is not None and n_samples == 1 and rotation != ROTATION_ON_DEVICE
            and (cached == FIELD_BYPASS or not capturing)):
        return cached
    return BAND if band else FRAME


def remap_tonemap(
    batch: torch.Tensor,
    rotation,
    *,
    in_lens: LensSpec,
    out_lens: LensSpec,
    out_h: int,
    out_w: int,
    interp: str = "bicubic",
    n_samples: int = 1,
    exposure: float = 1.0,
    reinhard: float = 1.0,
    row_offset: int = 0,
    row_count: Optional[int] = None,
) -> torch.Tensor:
    """(B, H, W, C) -> (B, row_count, out_w, C): remap, supersample and tonemap.

    Rows ``[row_offset, row_offset + row_count)`` of the ``out_h x out_w``
    frame (by default all of it), bit for bit those rows of the full
    frame; rows past ``out_h`` are computed as any other. A ``(V, 3, 3)``
    rotation stack gives the full frame's ``(B, V, out_h, out_w, C)``, view
    v bit for bit the call with ``rotation[v]``, in one launch of B1's view
    mode.
    A CPU tensor runs the plain version; a CUDA tensor launches B1 on the
    current stream of its device, or raises. A frame or band of a
    configuration called before samples from its coordinate field (the
    module's docstring).
    """
    kw = dict(in_lens=in_lens, out_lens=out_lens, out_h=out_h, out_w=out_w,
              interp=interp, n_samples=n_samples, exposure=exposure, reinhard=reinhard,
              row_offset=row_offset, row_count=row_count)
    if batch.device.type == "cpu":
        return remap_tonemap_plain(batch, rotation, **kw)
    return _launch("remap_tonemap", batch, rotation, None, None, remap.view_count(rotation), kw)


def remap_tonemap_list(
    batch: torch.Tensor,
    rotation,
    out: torch.Tensor,
    tiles: torch.Tensor,
    *,
    in_lens: LensSpec,
    out_lens: LensSpec,
    out_h: int,
    out_w: int,
    interp: str = "bicubic",
    n_samples: int = 1,
    exposure: float = 1.0,
    reinhard: float = 1.0,
    row_offset: int = 0,
    row_count: Optional[int] = None,
) -> torch.Tensor:
    """Writes B1's output at the listed 8 x 128 sub-tiles of ``out``, in place.

    ``tiles``: ``(n, 2)`` int32 (sub-tile row, sub-tile column), from
    ``ops/plan.py``, of the band of rows ``[row_offset, row_offset +
    row_count)`` (by default the whole frame): sub-tile rows count from the
    band's first row and ``out`` is ``(B, row_count, out_w, C)``. A CPU
    tensor runs the plain version; a CUDA tensor launches B1's list mode,
    or raises. Returns ``out``.
    """
    kw = dict(in_lens=in_lens, out_lens=out_lens, out_h=out_h, out_w=out_w,
              interp=interp, n_samples=n_samples, exposure=exposure, reinhard=reinhard,
              row_offset=row_offset, row_count=row_count)
    if batch.device.type == "cpu":
        return remap_tonemap_list_plain(batch, rotation, out, tiles, **kw)
    return _launch("remap_tonemap_list", batch, rotation, out, tiles, None, kw)


def _launch(name: str, batch: torch.Tensor, rotation, out: Optional[torch.Tensor],
            tiles: Optional[torch.Tensor], views: Optional[int], kw: dict) -> torch.Tensor:
    """B1 on a CUDA batch, with the module docstring's spans and counts, in
    the mode ``launch_mode`` picks: the frame, a band or every view into a
    new output (``out`` and ``tiles`` None), or the listed sub-tiles of
    ``out``; the field cache asked only where a field may serve."""
    spans = tracing.profiling()
    with tracing.Span("b1.wrapper") if spans else tracing.OFF:
        p, rot, stream = launch_setup(name, batch, rotation, views=views, spans=spans, **kw)
        if tiles is not None:
            check_output(name, out, batch, p)
            check_list(name, tiles, batch, 2)
            if tiles.shape[0] == 0:
                return out
        device, band = batch.device, p.row0 != 0 or p.band_rows != p.out_h
        if views is None and tiles is None and kw["n_samples"] == 1 and rot is None:
            with tracing.QuietSpan("b1.field") if spans else tracing.OFF:
                key = field_key(p, device, stream)
                field, cached = FIELDS.lookup(key, 8 * p.band_rows * p.out_w)
                mode = launch_mode(None, False, band, 1, p.has_rotation,
                                   torch.cuda.is_current_stream_capturing(), cached)
                if mode == FIELD_FILL:
                    field = torch.empty((p.band_rows, p.out_w, 2), dtype=torch.float32,
                                        device=device)
        else:
            mode = launch_mode(views, tiles is not None, band, kw["n_samples"], p.has_rotation)
        with tracing.QuietSpan("b1.launch") if spans else tracing.OFF:
            lib = library()
            if out is None:
                shape = (p.batch, p.band_rows) if views is None else (p.batch, views, p.out_h)
                out = torch.empty(shape + (p.out_w, p.channels), dtype=torch.float32,
                                  device=device)
            src, dst = batch.data_ptr(), out.data_ptr()
            ptr = None if rot is None else rot.data_ptr()
            at = (ctypes.byref(p), device.index, stream)
            if mode == FIELD_FILL:
                rc = lib.ilr_coord_field(field.data_ptr(), *at)
                if rc:
                    build.raise_on_error(lib, rc, "coordinate field kernel")
                FIELDS.put(key, field)
            if mode == FIELD_READ or mode == FIELD_FILL:
                rc = lib.ilr_remap_field(src, dst, field.data_ptr(), *at)
            elif mode == VIEWS:
                rc = lib.ilr_remap_views(src, dst, ptr, views, *at)
            elif tiles is not None:
                rc = lib.ilr_remap_list(src, dst, ptr, tiles.data_ptr(), int(tiles.shape[0]), *at)
            else:
                rc = lib.ilr_remap_frame(src, dst, ptr, *at)
            if rc:
                build.raise_on_error(lib, rc, f"remap kernel ({mode})")
    _COUNTS[mode] += 1
    if mode in _FIELD_MODES:
        _COUNTS[BAND if band else FRAME] += 1
    elif mode == VIEWS:
        _COUNTS["b1.views_computed"] += views
    return out
