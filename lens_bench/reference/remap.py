"""The plain reference remap: coordinates, sampling and tonemap.

Frozen copy of image-lens-reproject's per-pixel loop (reference
src/reproject.cpp:273-437): output pixel -> ray -> rotation -> source
pixel, nearest / bilinear / bicubic sampling with the reference's index
rules, n x n stratified supersampling, then exposure and extended Reinhard
on the first min(C, 3) channels. Plain PyTorch, float32, computed in
blocks of output rows so that a 4K frame fits beside nothing else.

``dtype`` selects the precision of the pixel arithmetic (texels, tap
weights, sums, tonemap): float32 for the reference, bfloat16 for the
control that every limit must reject. Coordinates stay float32 in both.

Index rules: C's ``int(float)`` (truncation toward zero, saturating to the
int32 range, NaN -> 0); horizontal wrap of a full-360 equirectangular
input as ``(int(s) + W) % W`` with the ``+ W`` in wrapping int32 and a
floor modulo; clamp to edge otherwise; vertical always clamps; fractions
against the wrapped or clamped low tap, clamped to [0, 1], NaN passed.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import projections as P

OFFSETS = {"nearest": (0.5,), "bilinear": (0.0, 1.0), "bicubic": (-1.0, 0.0, 1.0, 2.0)}
ROWS_PER_BLOCK = 256


def supersample_offsets(n: int):
    """(ss + 1) / (n + 1) - 0.5, float32-rounded (src/reproject.cpp:295)."""
    return [P.f32((ss + 1.0) / (n + 1.0) - 0.5) for ss in range(n)]


def trunc_i32(v):
    t = torch.nan_to_num(v.trunc(), nan=0.0, posinf=2.0**31, neginf=-(2.0**31))
    t = t.clamp(-(2.0**31), 2.0**31)
    return t.to(torch.int64).clamp(-(2**31), 2**31 - 1)


def taps(s, size: int, interp: str, wrap: bool):
    """Integer taps of one axis, wrapped or clamped."""
    out = []
    for k in OFFSETS[interp]:
        i = trunc_i32(s + k)
        if wrap:
            j = torch.remainder(i + (size + 2**31), 2**32) - 2**31
            out.append(torch.remainder(j, size))
        else:
            out.append(i.clamp(0, size - 1))
    return out


def weights(s, idx, interp: str, dtype):
    if interp == "nearest":
        return [torch.ones_like(s, dtype=dtype)]
    low = idx[0] if interp == "bilinear" else idx[1]
    t = torch.clamp(s - low.to(torch.float32), 0.0, 1.0).to(dtype)
    if interp == "bilinear":
        return [1.0 - t, t]
    t2 = t * t
    t3 = t2 * t
    return [0.5 * (-t + 2.0 * t2 - t3), 1.0 + 0.5 * (-5.0 * t2 + 3.0 * t3),
            0.5 * (t + 4.0 * t2 - 3.0 * t3), 0.5 * (-t2 + t3)]


def sample(flat, in_h: int, in_w: int, sx, sy, interp: str, wrap: bool, dtype):
    """(B, H*W, C) texels at (sx, sy) of shape S -> (B, *S, C) in ``dtype``."""
    xs = taps(sx, in_w, interp, wrap)
    ys = taps(sy, in_h, interp, False)
    wx = weights(sx, xs, interp, dtype)
    wy = weights(sy, ys, interp, dtype)

    def at(yi, xi):
        return flat[:, ys[yi] * in_w + xs[xi], :]

    if interp == "nearest":
        return at(0, 0)
    if interp == "bilinear":
        fx, fy = wx[1][..., None], wy[1][..., None]
        lo = fx * at(0, 1) + (1.0 - fx) * at(0, 0)
        up = fx * at(1, 1) + (1.0 - fx) * at(1, 0)
        return fy * up + (1.0 - fy) * lo
    acc = None
    for yi in range(4):
        row = None
        for xi in range(4):
            tap = at(yi, xi) * wx[xi][..., None]
            row = tap if row is None else row + tap
        row = row * wy[yi][..., None]
        acc = row if acc is None else acc + row
    return acc


def centres(index, size: int):
    return (index.to(torch.float32) + 0.5) - P.f32(size * 0.5)


def source_coords(cfg: dict, rotation, rows, cols, off_x: float = 0.0, off_y: float = 0.0):
    """Top-left-aligned source coordinates (sx, sy) of output pixels at
    (rows, cols), two broadcastable integer tensors; ``rotation`` a float32
    (3, 3) tensor or None."""
    out_w, out_h, in_w, in_h = cfg["out_w"], cfg["out_h"], cfg["src_w"], cfg["src_h"]
    vx, vy, vz = P.to_vec(cfg["out_lens"], float(out_w), float(out_h),
                          centres(cols, out_w) + off_x, centres(rows, out_h) + off_y)
    if rotation is not None:
        r = rotation
        vx, vy, vz = (r[0, 0] * vx + r[0, 1] * vy + r[0, 2] * vz,
                      r[1, 0] * vx + r[1, 1] * vy + r[1, 2] * vz,
                      r[2, 0] * vx + r[2, 1] * vy + r[2, 2] * vz)
    sx, sy = P.to_source(cfg["in_lens"], float(in_w), float(in_h), vx, vy, vz)
    return (sx - 0.5) + P.f32(in_w * 0.5), (sy - 0.5) + P.f32(in_h * 0.5)


def rotation_of(cfg: dict) -> Optional[np.ndarray]:
    """The configuration's rotation as float32 (3, 3), None for none."""
    rot = cfg.get("rotation_deg")
    if rot is None or not any(rot):
        return None
    return P.rotation_matrix_degrees(*rot)


def tonemap(v, exposure: float, reinhard: float):
    """Exposure (linear) and extended Reinhard on the first min(C, 3)
    channels (src/reproject.cpp:421-437); both 1 leaves ``v`` as it is."""
    if exposure == 1.0 and reinhard == 1.0:
        return v
    ch = min(int(v.shape[-1]), 3)
    x = v[..., :ch] * P.f32(exposure)
    x = x * (1.0 + x * P.f32(1.0 / (reinhard * reinhard))) / (1.0 + x)
    return x if ch == v.shape[-1] else torch.cat([x, v[..., ch:]], dim=-1)


def remap(src, cfg: dict, *, dtype=torch.float32, rows_per_block: int = ROWS_PER_BLOCK):
    """(B, src_h, src_w, C) -> (B, out_h, out_w, C) float32 on ``src``'s
    device, ``rows_per_block`` output rows at a time."""
    b, in_h, in_w, c = (int(d) for d in src.shape)
    if (in_h, in_w) != (cfg["src_h"], cfg["src_w"]):
        raise ValueError(f"source {in_h}x{in_w}, the configuration says "
                         f"{cfg['src_h']}x{cfg['src_w']}")
    rows, out_w = cfg["out_h"], cfg["out_w"]
    dev = src.device
    flat = src.reshape(b, in_h * in_w, c).to(dtype)
    rot = rotation_of(cfg)
    rot = None if rot is None else torch.as_tensor(rot, device=dev)
    wrap = P.wraps(cfg["in_lens"])
    interp, n = cfg["interp"], cfg.get("n_samples", 1)
    exposure = 2.0 ** cfg.get("exposure_ev", 0.0)
    reinhard = cfg.get("reinhard", 1.0)
    out = torch.empty((b, rows, out_w, c), dtype=torch.float32, device=dev)
    cols = torch.arange(out_w, device=dev)[None, :]
    for r0 in range(0, rows, rows_per_block):
        r1 = min(rows, r0 + rows_per_block)
        rr = torch.arange(r0, r1, device=dev)[:, None]
        acc = None
        for off_x in supersample_offsets(n):
            for off_y in supersample_offsets(n):
                sx, sy = source_coords(cfg, rot, rr, cols, off_x, off_y)
                tap = sample(flat, in_h, in_w, sx, sy, interp, wrap, dtype)
                acc = tap if acc is None else acc + tap
        acc = acc * P.f32(1.0 / (n * n))
        out[:, r0:r1] = tonemap(acc, exposure, reinhard).to(torch.float32)
    return out
