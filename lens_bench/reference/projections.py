"""Lens projections of the plain reference, in float32 PyTorch.

A frozen copy of the lens math of image-lens-reproject (reference
src/reproject.cpp:152-271, with the Blender equisolid model and the
stereographic model the port adds), written from the formulas and kept
here so that the benchmark judges the port by code the port cannot change.
A lens is a dict as the configuration files give it: ``type`` and the
lens's parameters (radians, millimetres).

Conventions: pixel centres, the image centred at (0, 0); the camera looks
down -z for rectilinear; fisheye forward maps give z = +cos(theta); the
equirectangular forward ray is not a unit vector and its inverse is
``-atan2(-x, -z)``; the inverse maps divide by -z unguarded. Every
constant is computed in double and rounded once to float32 (``f32``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

LENS_TYPES = ("rectilinear", "fisheye_equidistant", "fisheye_equisolid",
              "fisheye_stereographic", "equirectangular")


def f32(v: float) -> float:
    """``v`` rounded once to float32."""
    return float(np.float32(v))


def wraps(lens: dict) -> bool:
    """Whether sampling from ``lens`` wraps horizontally: a full-360
    equirectangular input (src/reproject.cpp:384-394)."""
    return (lens["type"] == "equirectangular"
            and abs(lens["longitude_max"] - lens["longitude_min"] - 2.0 * math.pi) < 1e-5)


def _fisheye_to_vec(cx, cy, r_scale, theta_of, center_slope):
    r_px = torch.sqrt(cx * cx + cy * cy)
    theta = theta_of(r_px * r_scale) if r_scale is not None else theta_of(r_px)
    safe_r = torch.where(r_px > 0, r_px, 1.0)
    s = torch.where(r_px > 0, torch.sin(theta) / safe_r, center_slope)
    return s * cx, s * cy, torch.cos(theta)


def to_vec(lens: dict, w: float, h: float, cx, cy):
    """Output pixel centres -> ray (x, y, z)."""
    t = lens["type"]
    if t == "rectilinear":
        f, sw, sh = lens["focal_length"], lens["sensor_width"], lens["sensor_height"]
        x = cx * f32(sw / (w * f))
        y = cy * f32(sh / (h * f))
        return x, y, torch.full_like(x, -1.0)
    if t == "fisheye_equidistant":
        fov = lens["fov"]
        return _fisheye_to_vec(cx, cy, None, lambda r: r * f32(fov / w), f32(fov / w))
    if t == "fisheye_equisolid":
        f, sw = lens["focal_length"], lens["sensor_width"]
        return _fisheye_to_vec(
            cx, cy, f32(sw / w),
            lambda r_mm: 2.0 * torch.asin(torch.clamp(r_mm * f32(1.0 / (2.0 * f)), -1.0, 1.0)),
            f32(sw / (f * w)))
    if t == "fisheye_stereographic":
        f, sw = lens["focal_length"], lens["sensor_width"]
        return _fisheye_to_vec(
            cx, cy, f32(sw / w),
            lambda r_mm: 2.0 * torch.atan(r_mm * f32(1.0 / (2.0 * f))),
            f32(sw / (f * w)))
    if t == "equirectangular":
        lo0, lo1 = lens["longitude_min"], lens["longitude_max"]
        la0, la1 = lens["latitude_min"], lens["latitude_max"]
        lon = (cx * f32(1.0 / w) + 0.5) * f32(lo1 - lo0) + f32(lo0)
        lat = (cy * f32(1.0 / h) + 0.5) * f32(la1 - la0) + f32(la0)
        return torch.sin(lon), torch.sin(lat), -torch.cos(lon)
    raise ValueError(f"unknown lens type {t!r}")


def _fisheye_to_source(x, y, z, r_px_of, center_scale):
    xn = x / -z
    yn = y / -z
    r = torch.sqrt(xn * xn + yn * yn)
    theta = torch.atan(r)
    r_px = r_px_of(theta)
    safe_r = torch.where(r > 0, r, 1.0)
    scale = torch.where(r > 0, r_px / safe_r, center_scale)
    return xn * scale, yn * scale


def to_source(lens: dict, w: float, h: float, x, y, z):
    """Ray -> centred source pixel coordinates (sx, sy)."""
    t = lens["type"]
    if t == "rectilinear":
        f, sw, sh = lens["focal_length"], lens["sensor_width"], lens["sensor_height"]
        xn = x / -z
        yn = y / -z
        return xn * f32(w * f / sw), yn * f32(h * f / sh)
    if t == "fisheye_equidistant":
        fov = lens["fov"]
        return _fisheye_to_source(x, y, z, lambda th: th * f32(w / fov), f32(w / fov))
    if t in ("fisheye_equisolid", "fisheye_stereographic"):
        f, sw = lens["focal_length"], lens["sensor_width"]
        fn = torch.sin if t == "fisheye_equisolid" else torch.tan
        return _fisheye_to_source(
            x, y, z, lambda th: (f32(2.0 * f) * fn(0.5 * th)) * f32(w / sw), f32(f * w / sw))
    if t == "equirectangular":
        lo0, lo1 = lens["longitude_min"], lens["longitude_max"]
        la0, la1 = lens["latitude_min"], lens["latitude_max"]
        theta = -torch.atan2(-x, -z)
        phi = torch.asin(y / torch.sqrt(x * x + y * y + z * z))
        sx = ((theta - f32(lo0)) * f32(1.0 / (lo1 - lo0)) - 0.5) * f32(w)
        sy = ((phi - f32(la0)) * f32(1.0 / (la1 - la0)) - 0.5) * f32(h)
        return sx, sy
    raise ValueError(f"unknown lens type {t!r}")


def rotation_matrix_degrees(pan: float, pitch: float, roll: float) -> np.ndarray:
    """R = R_y(pan) R_x(pitch) R_z(roll), degrees in, float32 (3, 3) out,
    multiplied in float32 as src/main.cpp:97-142 does."""
    a, b, c = (v * (math.pi / 180.0) for v in (pitch, pan, roll))
    r_x = np.array([[1, 0, 0], [0, math.cos(a), -math.sin(a)], [0, math.sin(a), math.cos(a)]],
                   dtype=np.float32)
    r_y = np.array([[math.cos(b), 0, math.sin(b)], [0, 1, 0], [-math.sin(b), 0, math.cos(b)]],
                   dtype=np.float32)
    r_z = np.array([[math.cos(c), -math.sin(c), 0], [math.sin(c), math.cos(c), 0], [0, 0, 1]],
                   dtype=np.float32)
    return (r_y @ (r_x @ r_z)).astype(np.float32)
