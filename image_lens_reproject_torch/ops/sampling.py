"""Gather-based interpolation samplers (nearest / bilinear / bicubic).

PyTorch port of the JAX package's ``ops/sampling.py`` together with the
tap math of its ``ops/pallas/taps.py::x_taps/y_taps``. These are the plain
versions of the taps that kernel B1 (``csrc/remap_kernel.cu``) computes
per pixel.

Index semantics, as the reference (src/reproject.cpp:37-148) and the JAX
package on its CPU backend give them:

* truncation toward zero (C's ``int(float)`` cast), saturating to the
  int32 range, with NaN -> 0 (what XLA's float->int32 convert gives);
* horizontal wrap (full-360 equirect input): ``(int(s) + W) % W`` with the
  ``+ W`` in wrapping int32 arithmetic and a floor modulo;
* clamp-to-edge otherwise; vertical always clamps;
* fractions measured against the already wrapped/clamped low tap, clamped
  to [0, 1] with NaN passed through.

Samplers take a source of shape ``(..., H, W, C)`` and coordinate fields
``sx, sy`` of one shape S, and return ``(..., *S, C)``: the leading dims
are a batch that shares one coordinate field.
"""

from __future__ import annotations

from typing import List, NamedTuple

import torch

Tensor = torch.Tensor

_I32_MIN = -(2**31)
_I32_MAX = 2**31 - 1

# tap offsets per interpolation mode, in trunc(s + k) form
_OFFSETS = {
    "nearest": (0.5,),
    "bilinear": (0.0, 1.0),
    "bicubic": (-1.0, 0.0, 1.0, 2.0),
}


def _trunc_i32(v: Tensor) -> Tensor:
    """C's (int) cast as XLA's CPU backend gives it, as int64 indices.

    Truncates toward zero and saturates to the int32 range; NaN gives 0.
    (A bare ``.to(torch.int32)`` leaves inf and NaN undefined.)
    """
    t = torch.nan_to_num(v.trunc(), nan=0.0, posinf=2.0**31, neginf=-(2.0**31))
    t = t.clamp(-(2.0**31), 2.0**31)  # exact in float32
    return t.to(torch.int64).clamp(_I32_MIN, _I32_MAX)


def _wrap_w(i: Tensor, width: int) -> Tensor:
    """``(i + width) % width`` with int32 wraparound on the add, floor modulo."""
    j = torch.remainder(i + (width + 2**31), 2**32) - 2**31
    return torch.remainder(j, width)


def _clamp(i: Tensor, hi: int) -> Tensor:
    return i.clamp(0, hi)


def _frac(s: Tensor, low: Tensor) -> Tensor:
    return torch.clamp(s - low.to(torch.float32), 0.0, 1.0)


def cubic_weights(t: Tensor):
    """Catmull-Rom-family weights matching the reference's Horner cubic.

    cubic(p, t) = p1 + 0.5 t (p2 - p0 + t (2 p0 - 5 p1 + 4 p2 - p3
                  + t (3 (p1 - p2) + p3 - p0)))   (src/reproject.cpp:92-98)
    """
    t2 = t * t
    t3 = t2 * t
    w0 = 0.5 * (-t + 2.0 * t2 - t3)
    w1 = 1.0 + 0.5 * (-5.0 * t2 + 3.0 * t3)
    w2 = 0.5 * (t + 4.0 * t2 - 3.0 * t3)
    w3 = 0.5 * (-t2 + t3)
    return w0, w1, w2, w3


class Taps(NamedTuple):
    """Integer taps (after wrap/clamp) and per-tap weights for one axis."""

    idx: List[Tensor]
    weights: List[Tensor]


def _weights(s: Tensor, idx: List[Tensor], interp: str) -> List[Tensor]:
    if interp == "nearest":
        return [torch.ones_like(s)]
    if interp == "bilinear":
        f = _frac(s, idx[0])
        return [1.0 - f, f]
    return list(cubic_weights(_frac(s, idx[1])))


def x_taps(sx: Tensor, width: int, interp: str, wrap: bool) -> Taps:
    idx = []
    for k in _OFFSETS[interp]:
        i = _trunc_i32(sx + k)
        idx.append(_wrap_w(i, width) if wrap else _clamp(i, width - 1))
    return Taps(idx=idx, weights=_weights(sx, idx, interp))


def y_taps(sy: Tensor, height: int, interp: str) -> Taps:
    idx = [_clamp(_trunc_i32(sy + k), height - 1) for k in _OFFSETS[interp]]
    return Taps(idx=idx, weights=_weights(sy, idx, interp))


def _gather(flat: Tensor, ly: Tensor, lx: Tensor, width: int) -> Tensor:
    """Fetch (..., *S, C) pixels from (..., H*W, C) at row/col indices of shape S."""
    return flat[..., ly * width + lx, :]


def _flatten(src: Tensor):
    h, w = int(src.shape[-3]), int(src.shape[-2])
    return src.reshape(*src.shape[:-3], h * w, src.shape[-1]), h, w


def sample_nearest(src: Tensor, sx: Tensor, sy: Tensor, wrap: bool) -> Tensor:
    """Nearest: round via int(s + 0.5) (reference src/reproject.cpp:40-53)."""
    flat, h, w = _flatten(src)
    lx = x_taps(sx, w, "nearest", wrap).idx[0]
    ly = y_taps(sy, h, "nearest").idx[0]
    return _gather(flat, ly, lx, w)


def sample_bilinear(src: Tensor, sx: Tensor, sy: Tensor, wrap: bool) -> Tensor:
    """4-tap bilinear (reference src/reproject.cpp:55-90)."""
    flat, h, w = _flatten(src)
    (lx, ux), (_, fx) = x_taps(sx, w, "bilinear", wrap)
    (ly, uy), (_, fy) = y_taps(sy, h, "bilinear")
    fx = fx[..., None]
    fy = fy[..., None]

    ll = _gather(flat, ly, lx, w)
    lu = _gather(flat, ly, ux, w)
    ul = _gather(flat, uy, lx, w)
    uu = _gather(flat, uy, ux, w)

    lo = fx * lu + (1.0 - fx) * ll
    up = fx * uu + (1.0 - fx) * ul
    return fy * up + (1.0 - fy) * lo


def sample_bicubic(src: Tensor, sx: Tensor, sy: Tensor, wrap: bool) -> Tensor:
    """16-tap separable bicubic (reference src/reproject.cpp:100-148).

    Accumulation order: the x-weighted sum along a row, then times wy, then
    the sum over rows, as the JAX package's ``sample_bicubic``.
    """
    flat, h, w = _flatten(src)
    xs, wx = x_taps(sx, w, "bicubic", wrap)
    ys, wy = y_taps(sy, h, "bicubic")

    acc = None
    for yi in range(4):
        row = None
        for xi in range(4):
            tap = _gather(flat, ys[yi], xs[xi], w) * wx[xi][..., None]
            row = tap if row is None else row + tap
        row = row * wy[yi][..., None]
        acc = row if acc is None else acc + row
    return acc


SAMPLERS = {
    "nearest": sample_nearest,
    "bilinear": sample_bilinear,
    "bicubic": sample_bicubic,
}


def sample(src: Tensor, sx: Tensor, sy: Tensor, interp: str, wrap: bool) -> Tensor:
    """Dispatch on interpolation mode (reference src/reproject.cpp:348-368)."""
    try:
        fn = SAMPLERS[interp]
    except KeyError:
        raise ValueError(f"Interpolation method not supported: {interp!r}")
    return fn(src, sx, sy, wrap)
