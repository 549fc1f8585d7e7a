"""Wrapper of kernel B1 (``csrc/remap_kernel.cu``): fused remap + tonemap.

B1 covers every combination the JAX package's K1 accepts: any of the five
lenses on either side (rectilinear, equidistant, equisolid, stereographic,
equirectangular, full or partial), nearest, bilinear or bicubic sampling,
any supersample count, channel count, rotation and tonemap.

Two entry points, each with its plain PyTorch version beside it:

- ``remap_tonemap`` takes a ``(B, H, W, C)`` float32 batch and returns the
  whole output frame;
- ``remap_tonemap_list`` (B1's list mode) writes only the listed 8 x 128
  output sub-tiles of an existing output, in place.

A CPU tensor goes to the plain version (``ops/remap.py`` then
``ops/color.py``). A CUDA tensor launches B1 or raises: there is no
fallback. ``LAUNCHES`` and ``LIST_LAUNCHES`` count the launches of each
entry point, so that a run can show it went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

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
from .. import color, remap
from . import build

SOURCES = ("remap_kernel.cu",)
LAUNCHES = 0
LIST_LAUNCHES = 0
_MAX_BATCH = 65535  # gridDim.y / gridDim.z

# Mirrored by the LensCode and InterpCode enums of csrc/remap_device.cuh.
LENS_CODES = {
    Rectilinear: 0,
    FisheyeEquidistant: 1,
    FisheyeEquisolid: 2,
    FisheyeStereographic: 3,
    Equirectangular: 4,
}
INTERP_CODES = {"nearest": 0, "bilinear": 1, "bicubic": 2}


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
    ] + [("out_k", ctypes.c_float * 6), ("in_k", ctypes.c_float * 6)]


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
) -> torch.Tensor:
    """The plain PyTorch version of B1, on whatever device ``batch`` lies."""
    out = remap.remap_batch(
        batch, rotation, in_lens=in_lens, out_lens=out_lens,
        out_h=out_h, out_w=out_w, interp=interp, n_samples=n_samples,
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
) -> torch.Tensor:
    """The plain version of B1's list mode: ``out`` at ``tiles`` only, in place.

    ``tiles`` is an ``(n, 2)`` integer tensor of (sub-tile row, sub-tile
    column) on 8 x 128 output sub-tiles. The pixels are computed on the
    pixel centres of those sub-tiles only (``remap.remap_subtiles``).
    """
    vals = remap.remap_subtiles(
        batch, rotation, tiles, in_lens=in_lens, out_lens=out_lens,
        out_h=out_h, out_w=out_w, interp=interp, n_samples=n_samples,
    )
    if color.needed(exposure, reinhard):
        vals = color.post_process(vals, exposure, reinhard)
    remap.scatter_subtiles(out, vals, tiles)
    return out


@functools.cache
def library() -> ctypes.CDLL:
    """B1's shared library, built from ``csrc/`` by nvcc at the first call."""
    lib = build.load("ilr_remap", SOURCES)
    lib.ilr_remap_frame.restype = ctypes.c_int
    lib.ilr_remap_frame.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.POINTER(RemapParams), ctypes.c_int, ctypes.c_void_p,
    ]
    lib.ilr_remap_list.restype = ctypes.c_int
    lib.ilr_remap_list.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.POINTER(RemapParams), ctypes.c_int, ctypes.c_void_p,
    ]
    return build.check_params(lib, RemapParams)


def params(
    batch_shape, *, in_lens: LensSpec, out_lens: LensSpec, out_h: int, out_w: int,
    interp: str, n_samples: int, exposure: float, reinhard: float, has_rotation: bool,
) -> RemapParams:
    """B1's launch constants, each float rounded once to float32 from double."""
    b, in_h, in_w, c = (int(d) for d in batch_shape)
    return RemapParams(
        batch=b, in_h=in_h, in_w=in_w, channels=c, out_h=out_h, out_w=out_w,
        n_samples=n_samples, wrap=int(wrap_mode_for_input(in_lens)),
        has_rotation=int(has_rotation), tonemap=int(color.needed(exposure, reinhard)),
        out_lens=LENS_CODES[type(out_lens)], in_lens=LENS_CODES[type(in_lens)],
        interp=INTERP_CODES[interp],
        out_half_w=_f32(out_w * 0.5), out_half_h=_f32(out_h * 0.5),
        in_half_w=_f32(in_w * 0.5), in_half_h=_f32(in_h * 0.5),
        normalize=_f32(1.0 / (n_samples * n_samples)),
        exposure=_f32(exposure), inv_max2=_f32(1.0 / (reinhard * reinhard)),
        out_k=(ctypes.c_float * 6)(*out_constants(out_lens, float(out_w), float(out_h))),
        in_k=(ctypes.c_float * 6)(*in_constants(in_lens, float(in_w), float(in_h))),
    )


def launch_setup(name: str, batch: torch.Tensor, rotation, *, in_lens, out_lens, out_h, out_w,
                 interp, n_samples, exposure, reinhard):
    """Checks a CUDA batch and the combination; returns (params, rotation, stream).

    Raises on what the kernels do not take: another device or dtype, a
    non-contiguous or badly shaped batch, or an uncovered combination.
    """
    if batch.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {batch.device}")
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
    rot = remap.rotation_tensor(rotation, batch.device)
    if rot is not None:
        rot = rot.contiguous()
    p = params(batch.shape, in_lens=in_lens, out_lens=out_lens, out_h=out_h, out_w=out_w,
               interp=interp, n_samples=n_samples, exposure=exposure, reinhard=reinhard,
               has_rotation=rot is not None)
    stream = torch.cuda.current_stream(batch.device).cuda_stream
    return p, rot, stream


def check_output(name: str, out: torch.Tensor, batch: torch.Tensor, out_h: int, out_w: int):
    """An in-place output must be the batch's (B, out_h, out_w, C) float32 on its device."""
    want = (int(batch.shape[0]), out_h, out_w, int(batch.shape[3]))
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
) -> torch.Tensor:
    """(B, H, W, C) -> (B, out_h, out_w, C): remap, supersample and tonemap.

    A CPU tensor runs the plain version; a CUDA tensor launches B1 on the
    current stream of its device, or raises.
    """
    global LAUNCHES
    kw = dict(in_lens=in_lens, out_lens=out_lens, out_h=out_h, out_w=out_w,
              interp=interp, n_samples=n_samples, exposure=exposure, reinhard=reinhard)
    if batch.device.type == "cpu":
        return remap_tonemap_plain(batch, rotation, **kw)
    p, rot, stream = launch_setup("remap_tonemap", batch, rotation, **kw)
    lib = library()
    out = torch.empty((p.batch, out_h, out_w, p.channels), dtype=torch.float32,
                      device=batch.device)
    rc = lib.ilr_remap_frame(
        batch.data_ptr(), out.data_ptr(), None if rot is None else rot.data_ptr(),
        ctypes.byref(p), batch.device.index, stream,
    )
    build.raise_on_error(lib, rc, "remap kernel")
    LAUNCHES += 1
    return out


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
) -> torch.Tensor:
    """Writes B1's output at the listed 8 x 128 sub-tiles of ``out``, in place.

    ``tiles``: ``(n, 2)`` int32 (sub-tile row, sub-tile column), from
    ``ops/plan.py``. A CPU tensor runs the plain version; a CUDA tensor
    launches B1's list mode, or raises. Returns ``out``.
    """
    global LIST_LAUNCHES
    kw = dict(in_lens=in_lens, out_lens=out_lens, out_h=out_h, out_w=out_w,
              interp=interp, n_samples=n_samples, exposure=exposure, reinhard=reinhard)
    if batch.device.type == "cpu":
        return remap_tonemap_list_plain(batch, rotation, out, tiles, **kw)
    p, rot, stream = launch_setup("remap_tonemap_list", batch, rotation, **kw)
    check_output("remap_tonemap_list", out, batch, out_h, out_w)
    check_list("remap_tonemap_list", tiles, batch, 2)
    if tiles.shape[0] == 0:
        return out
    lib = library()
    rc = lib.ilr_remap_list(
        batch.data_ptr(), out.data_ptr(), None if rot is None else rot.data_ptr(),
        tiles.data_ptr(), int(tiles.shape[0]), ctypes.byref(p), batch.device.index, stream,
    )
    build.raise_on_error(lib, rc, "remap list kernel")
    LIST_LAUNCHES += 1
    return out
