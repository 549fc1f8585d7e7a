"""Pure projection math: pixel coordinate <-> light ray, per lens model.

PyTorch port of the JAX package's ``models/projections.py``. Every function
maps float32 coordinate tensors (any shape, any device) elementwise, with
the same formulas in the same order, so the two packages agree to the
last few ulps of the device's libm.

Coordinate convention (reference src/reproject.cpp:10-13): pixel centers,
image centered at (0, 0), corners at (±0.5*w, ±0.5*h). The camera looks
down -z for rectilinear. The reference's quirks are kept verbatim:

* the fisheye forward maps emit z = +cos(theta) (src/reproject.cpp:185);
* the equirectangular forward ray is not a unit vector;
* the equirectangular inverse is ``-atan2(-x, -z)``, which keeps the sign
  of a -0.0 at the 360° seam;
* the inverse maps divide by -z unguarded;
* the fisheye center pixel is guarded with a where().

Every constant the JAX code rounds with ``xp.float32(expr)`` is computed
in double here too and rounded once to float32 (``_f32``), so that the
tensor ops see the same float32 operand.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .lens import (
    Equirectangular,
    FisheyeEquidistant,
    FisheyeEquisolid,
    FisheyeStereographic,
    LensSpec,
    Rectilinear,
)

Tensor = torch.Tensor


def _f32(v: float) -> float:
    """``v`` rounded once to float32 (exact as a float32 operand)."""
    return float(np.float32(v))


# === RECTILINEAR (reference src/reproject.cpp:152-167) ===


def rectilinear_to_vec(
    lens: Rectilinear, img_w: float, img_h: float, cx: Tensor, cy: Tensor
) -> Tuple[Tensor, Tensor, Tensor]:
    """Pixel -> ray. x = cx/w * sensor_w/f, y likewise, z = -1."""
    x = cx * _f32(lens.sensor_width / (img_w * lens.focal_length))
    y = cy * _f32(lens.sensor_height / (img_h * lens.focal_length))
    z = torch.full_like(x, -1.0)
    return x, y, z


def vec_to_rectilinear(
    lens: Rectilinear, img_w: float, img_h: float, x: Tensor, y: Tensor, z: Tensor
) -> Tuple[Tensor, Tensor]:
    """Ray -> pixel: perspective divide by -z, scale to pixels."""
    xn = x / -z
    yn = y / -z
    gx = _f32(img_w * lens.focal_length / lens.sensor_width)
    gy = _f32(img_h * lens.focal_length / lens.sensor_height)
    return xn * gx, yn * gy


# === FISHEYE EQUIDISTANT (reference src/reproject.cpp:171-206) ===


def equidistant_to_vec(
    lens: FisheyeEquidistant, img_w: float, img_h: float, cx: Tensor, cy: Tensor
) -> Tuple[Tensor, Tensor, Tensor]:
    """Pixel -> ray: theta = r_mm / f with f = sensor_w / fov; z = +cos(theta)."""
    r_px = torch.sqrt(cx * cx + cy * cy)
    theta = r_px * _f32(lens.fov / img_w)
    safe_r = torch.where(r_px > 0, r_px, 1.0)
    s = torch.where(r_px > 0, torch.sin(theta) / safe_r, _f32(lens.fov / img_w))
    return s * cx, s * cy, torch.cos(theta)


def vec_to_equidistant(
    lens: FisheyeEquidistant, img_w: float, img_h: float, x: Tensor, y: Tensor, z: Tensor
) -> Tuple[Tensor, Tensor]:
    """Ray -> pixel via perspective divide then theta = atan(r)."""
    xn = x / -z
    yn = y / -z
    r = torch.sqrt(xn * xn + yn * yn)
    theta = torch.atan(r)
    r_px = theta * _f32(img_w / lens.fov)
    safe_r = torch.where(r > 0, r, 1.0)
    scale = torch.where(r > 0, r_px / safe_r, _f32(img_w / lens.fov))
    return xn * scale, yn * scale


# === FISHEYE EQUISOLID (Blender model, r_mm = 2 f sin(theta/2)) ===


def equisolid_to_vec(
    lens: FisheyeEquisolid, img_w: float, img_h: float, cx: Tensor, cy: Tensor
) -> Tuple[Tensor, Tensor, Tensor]:
    """Pixel -> ray: theta = 2 asin(r_mm / (2 f)), asin argument clamped to [-1, 1]."""
    r_px = torch.sqrt(cx * cx + cy * cy)
    r_mm = r_px * _f32(lens.sensor_width / img_w)
    a = r_mm * _f32(1.0 / (2.0 * lens.focal_length))
    a = torch.clamp(a, -1.0, 1.0)
    theta = 2.0 * torch.asin(a)
    safe_r = torch.where(r_px > 0, r_px, 1.0)
    center_slope = _f32(lens.sensor_width / (lens.focal_length * img_w))
    s = torch.where(r_px > 0, torch.sin(theta) / safe_r, center_slope)
    return s * cx, s * cy, torch.cos(theta)


def vec_to_equisolid(
    lens: FisheyeEquisolid, img_w: float, img_h: float, x: Tensor, y: Tensor, z: Tensor
) -> Tuple[Tensor, Tensor]:
    """Ray -> pixel: theta = atan(r) after perspective divide, r_mm = 2 f sin(theta/2)."""
    xn = x / -z
    yn = y / -z
    r = torch.sqrt(xn * xn + yn * yn)
    theta = torch.atan(r)
    r_mm = _f32(2.0 * lens.focal_length) * torch.sin(0.5 * theta)
    r_px = r_mm * _f32(img_w / lens.sensor_width)
    safe_r = torch.where(r > 0, r, 1.0)
    center_slope = _f32(lens.focal_length * img_w / lens.sensor_width)
    scale = torch.where(r > 0, r_px / safe_r, center_slope)
    return xn * scale, yn * scale


# === FISHEYE STEREOGRAPHIC (r_mm = 2 f tan(theta/2)) ===


def stereographic_to_vec(
    lens: FisheyeStereographic, img_w: float, img_h: float, cx: Tensor, cy: Tensor
) -> Tuple[Tensor, Tensor, Tensor]:
    """Pixel -> ray: theta = 2 atan(r_mm / (2 f))."""
    r_px = torch.sqrt(cx * cx + cy * cy)
    r_mm = r_px * _f32(lens.sensor_width / img_w)
    theta = 2.0 * torch.atan(r_mm * _f32(1.0 / (2.0 * lens.focal_length)))
    safe_r = torch.where(r_px > 0, r_px, 1.0)
    center_slope = _f32(lens.sensor_width / (lens.focal_length * img_w))
    s = torch.where(r_px > 0, torch.sin(theta) / safe_r, center_slope)
    return s * cx, s * cy, torch.cos(theta)


def vec_to_stereographic(
    lens: FisheyeStereographic, img_w: float, img_h: float, x: Tensor, y: Tensor, z: Tensor
) -> Tuple[Tensor, Tensor]:
    """Ray -> pixel: theta = atan(r) after perspective divide, r_mm = 2 f tan(theta/2)."""
    xn = x / -z
    yn = y / -z
    r = torch.sqrt(xn * xn + yn * yn)
    theta = torch.atan(r)
    r_mm = _f32(2.0 * lens.focal_length) * torch.tan(0.5 * theta)
    r_px = r_mm * _f32(img_w / lens.sensor_width)
    safe_r = torch.where(r > 0, r, 1.0)
    center_slope = _f32(lens.focal_length * img_w / lens.sensor_width)
    scale = torch.where(r > 0, r_px / safe_r, center_slope)
    return xn * scale, yn * scale


# === EQUIRECTANGULAR (reference src/reproject.cpp:245-271) ===


def equirectangular_to_vec(
    lens: Equirectangular, img_w: float, img_h: float, cx: Tensor, cy: Tensor
) -> Tuple[Tensor, Tensor, Tensor]:
    """Pixel -> ray, without the cos(latitude) scaling: not a unit vector."""
    lon = (cx * _f32(1.0 / img_w) + 0.5) * _f32(lens.longitude_span) + _f32(lens.longitude_min)
    lat = (cy * _f32(1.0 / img_h) + 0.5) * _f32(lens.latitude_span) + _f32(lens.latitude_min)
    return torch.sin(lon), torch.sin(lat), -torch.cos(lon)


def vec_to_equirectangular(
    lens: Equirectangular, img_w: float, img_h: float, x: Tensor, y: Tensor, z: Tensor
) -> Tuple[Tensor, Tensor]:
    """Ray -> pixel: theta = -atan2(-x, -z), phi = asin(y / |v|)."""
    theta = -torch.atan2(-x, -z)
    phi = torch.asin(y / torch.sqrt(x * x + y * y + z * z))
    cx = ((theta - _f32(lens.longitude_min)) * _f32(1.0 / lens.longitude_span) - 0.5) * _f32(img_w)
    cy = ((phi - _f32(lens.latitude_min)) * _f32(1.0 / lens.latitude_span) - 0.5) * _f32(img_h)
    return cx, cy


# === dispatch tables ===

_TO_VEC = {
    Rectilinear: rectilinear_to_vec,
    FisheyeEquidistant: equidistant_to_vec,
    FisheyeEquisolid: equisolid_to_vec,
    FisheyeStereographic: stereographic_to_vec,
    Equirectangular: equirectangular_to_vec,
}

_TO_SOURCE = {
    Rectilinear: vec_to_rectilinear,
    FisheyeEquidistant: vec_to_equidistant,
    FisheyeEquisolid: vec_to_equisolid,
    FisheyeStereographic: vec_to_stereographic,
    Equirectangular: vec_to_equirectangular,
}


def target_to_vec(
    lens: LensSpec, img_w: float, img_h: float, cx: Tensor, cy: Tensor
) -> Tuple[Tensor, Tensor, Tensor]:
    """Dispatch on output-lens type (reference src/reproject.cpp:405-419)."""
    try:
        fn = _TO_VEC[type(lens)]
    except KeyError:
        raise ValueError(f"Output lens type not supported: {type(lens).__name__}")
    return fn(lens, img_w, img_h, cx, cy)


def vec_to_source(
    lens: LensSpec, img_w: float, img_h: float, x: Tensor, y: Tensor, z: Tensor
) -> Tuple[Tensor, Tensor]:
    """Dispatch on input-lens type (reference src/reproject.cpp:375-399)."""
    try:
        fn = _TO_SOURCE[type(lens)]
    except KeyError:
        raise ValueError(f"Input lens type not supported: {type(lens).__name__}")
    return fn(lens, img_w, img_h, x, y, z)
