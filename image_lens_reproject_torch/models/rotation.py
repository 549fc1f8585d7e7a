"""Euler-angle rotation matrix builder.

Reference: src/main.cpp:97-142 — R = R_y(pan) · R_x(pitch) · R_z(roll),
with angles given in degrees on the CLI and converted to radians
(src/main.cpp:312-325). The reference always builds a matrix (the default
"0.0" rotation string produces the identity), so the remap path can always
apply the 3x3 multiply unconditionally; we instead let callers skip the
multiply when the matrix is exactly identity (bitwise-equal results, one
fewer fused op).
"""

from __future__ import annotations

import math

import numpy as np


def rotation_matrix(pan: float, pitch: float, roll: float) -> np.ndarray:
    """Build the 3x3 rotation matrix R = R_y(pan) @ R_x(pitch) @ R_z(roll).

    Angles in radians. Returns float32 (3, 3), row-major — applied to
    column vectors as in the reference's explicit 9-multiply
    (src/reproject.cpp:303-311).
    """
    cx, sx = math.cos(pitch), math.sin(pitch)
    cy, sy = math.cos(pan), math.sin(pan)
    cz, sz = math.cos(roll), math.sin(roll)

    r_x = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]], dtype=np.float32)
    r_y = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]], dtype=np.float32)
    r_z = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]], dtype=np.float32)

    # Reference multiplies in float32: temp = R_x * R_z, then R_y * temp
    # (src/main.cpp:137-140).
    return (r_y @ (r_x @ r_z)).astype(np.float32)


def rotation_matrix_degrees(pan_deg: float, pitch_deg: float, roll_deg: float) -> np.ndarray:
    """CLI-facing variant: degrees -> radians as in src/main.cpp:316-321."""
    to_rad = math.pi / 180.0
    return rotation_matrix(pan_deg * to_rad, pitch_deg * to_rad, roll_deg * to_rad)


def is_identity(rm: np.ndarray, tol: float = 0.0) -> bool:
    """Exact (or tol-bounded) identity check used to skip the rotate stage."""
    return bool(np.all(np.abs(rm - np.eye(3, dtype=np.float32)) <= tol))
