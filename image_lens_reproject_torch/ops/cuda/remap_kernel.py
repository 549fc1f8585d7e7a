"""Wrapper of kernel B1 (``csrc/remap_kernel.cu``): fused remap + tonemap.

``remap_tonemap`` takes a ``(B, H, W, C)`` float32 batch. A CPU tensor goes
to the plain version, ``remap_tonemap_plain`` (``ops/remap.py`` then
``ops/color.py``). A CUDA tensor launches B1 or raises: there is no
fallback. B1 covers an equirectangular input (full, which wraps, or
partial, which clamps), a rectilinear output and bicubic sampling, with
any supersample count, channel count, rotation or tonemap; any other
combination on a CUDA tensor raises NotImplementedError.

``LAUNCHES`` counts the kernel's launches, so that a run can show it went
through the kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from ...models.lens import Equirectangular, LensSpec, Rectilinear, wrap_mode_for_input
from .. import color, remap
from . import build

SOURCES = ("remap_kernel.cu",)
LAUNCHES = 0
_MAX_BATCH = 65535  # gridDim.z


class RemapParams(ctypes.Structure):
    """Mirror of ``struct RemapParams`` in the .cu, field for field."""

    _fields_ = [
        (name, ctypes.c_int32)
        for name in (
            "batch", "in_h", "in_w", "channels", "out_h", "out_w",
            "n_samples", "wrap", "has_rotation", "tonemap",
        )
    ] + [
        (name, ctypes.c_float)
        for name in (
            "out_half_w", "out_half_h", "ray_fx", "ray_fy",
            "lon_min", "inv_lon_span", "lat_min", "inv_lat_span",
            "in_w_f", "in_h_f", "in_half_w", "in_half_h",
            "normalize", "exposure", "inv_max2",
        )
    ]


def _f32(v: float) -> float:
    return float(np.float32(v))


def uncovered(in_lens: LensSpec, out_lens: LensSpec, interp: str) -> Optional[str]:
    """Why B1 cannot run this combination, or None when it can."""
    if not isinstance(in_lens, Equirectangular) or not isinstance(out_lens, Rectilinear):
        return (
            f"{type(in_lens).__name__} -> {type(out_lens).__name__}: kernel B1 covers "
            "Equirectangular -> Rectilinear only"
        )
    if interp != "bicubic":
        return f"interp={interp!r}: kernel B1 covers bicubic only"
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


@functools.cache
def library() -> ctypes.CDLL:
    """B1's shared library, built from ``csrc/`` by nvcc at the first call."""
    lib = build.load("ilr_remap", SOURCES)
    lib.ilr_remap_equirect_rect_bicubic.restype = ctypes.c_int
    lib.ilr_remap_equirect_rect_bicubic.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.POINTER(RemapParams), ctypes.c_int, ctypes.c_void_p,
    ]
    lib.ilr_cuda_error_string.restype = ctypes.c_char_p
    lib.ilr_cuda_error_string.argtypes = [ctypes.c_int]
    lib.ilr_params_size.restype = ctypes.c_int
    lib.ilr_params_size.argtypes = []
    if lib.ilr_params_size() != ctypes.sizeof(RemapParams):
        raise RuntimeError("RemapParams differs between remap_kernel.cu and its wrapper")
    return lib


def params(
    batch_shape, *, in_lens: Equirectangular, out_lens: Rectilinear, out_h: int, out_w: int,
    n_samples: int, exposure: float, reinhard: float, has_rotation: bool,
) -> RemapParams:
    """B1's launch constants, each float rounded once to float32 from double."""
    b, in_h, in_w, c = (int(d) for d in batch_shape)
    return RemapParams(
        batch=b, in_h=in_h, in_w=in_w, channels=c, out_h=out_h, out_w=out_w,
        n_samples=n_samples, wrap=int(wrap_mode_for_input(in_lens)),
        has_rotation=int(has_rotation), tonemap=int(color.needed(exposure, reinhard)),
        out_half_w=_f32(out_w * 0.5), out_half_h=_f32(out_h * 0.5),
        ray_fx=_f32(out_lens.sensor_width / (float(out_w) * out_lens.focal_length)),
        ray_fy=_f32(out_lens.sensor_height / (float(out_h) * out_lens.focal_length)),
        lon_min=_f32(in_lens.longitude_min),
        inv_lon_span=_f32(1.0 / in_lens.longitude_span),
        lat_min=_f32(in_lens.latitude_min),
        inv_lat_span=_f32(1.0 / in_lens.latitude_span),
        in_w_f=_f32(float(in_w)), in_h_f=_f32(float(in_h)),
        in_half_w=_f32(in_w * 0.5), in_half_h=_f32(in_h * 0.5),
        normalize=_f32(1.0 / (n_samples * n_samples)),
        exposure=_f32(exposure), inv_max2=_f32(1.0 / (reinhard * reinhard)),
    )


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
    if batch.device.type != "cuda":
        raise ValueError(f"remap_tonemap: unsupported device {batch.device}")
    why = uncovered(in_lens, out_lens, interp)
    if why is not None:
        raise NotImplementedError(why)
    if batch.dtype != torch.float32:
        raise TypeError(f"remap_tonemap: expected float32, got {batch.dtype}")
    if batch.ndim != 4 or not batch.is_contiguous():
        raise ValueError(f"remap_tonemap: expected a contiguous (B, H, W, C) tensor, "
                         f"got shape {tuple(batch.shape)}")
    b, in_h, in_w, c = (int(d) for d in batch.shape)
    if in_h < 2 or in_w < 2 or c < 1 or not 1 <= b <= _MAX_BATCH:
        raise ValueError(f"remap_tonemap: unsupported batch shape {tuple(batch.shape)}")
    if out_h < 1 or out_w < 1 or n_samples < 1:
        raise ValueError(f"remap_tonemap: bad out_h={out_h}, out_w={out_w} "
                         f"or n_samples={n_samples}")
    rot = remap.rotation_tensor(rotation, batch.device)
    if rot is not None:
        rot = rot.contiguous()

    p = params(batch.shape, in_lens=in_lens, out_lens=out_lens, out_h=out_h, out_w=out_w,
               n_samples=n_samples, exposure=exposure, reinhard=reinhard,
               has_rotation=rot is not None)
    lib = library()
    out = torch.empty((b, out_h, out_w, c), dtype=torch.float32, device=batch.device)
    stream = torch.cuda.current_stream(batch.device).cuda_stream
    rc = lib.ilr_remap_equirect_rect_bicubic(
        batch.data_ptr(), out.data_ptr(), None if rot is None else rot.data_ptr(),
        ctypes.byref(p), batch.device.index, stream,
    )
    if rc != 0:
        raise RuntimeError(f"remap kernel launch failed: CUDA error {rc} "
                           f"({lib.ilr_cuda_error_string(rc).decode()})")
    LAUNCHES += 1
    return out
