"""The reprojection remap in plain PyTorch: the port's plain path.

PyTorch port of the JAX package's ``ops/remap.py`` (reference
src/reproject.cpp:273-346): a dense coordinate field (pixel -> ray ->
rotate -> source pixel) followed by a gather-interpolate. It runs on any
device; the CPU tests run it, and it is the plain version that kernel B1
(``csrc/remap_kernel.cu``) is held against on the card.

Supersampling (reference src/reproject.cpp:294-341): n x n stratified
sub-pixel offsets ``(ss+1)/(n+1) - 0.5``, off_x outer and off_y inner,
summed and then multiplied by 1/n².
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..models import projections
from ..models.lens import LensSpec, wrap_mode_for_input
from . import sampling

Tensor = torch.Tensor


def supersample_offsets(n_samples: int) -> List[float]:
    """Stratified sub-pixel offsets (reference src/reproject.cpp:295, 298), float32-rounded."""
    return [float(np.float32((ss + 1.0) / (n_samples + 1.0) - 0.5)) for ss in range(n_samples)]


def rotation_tensor(rotation, device: torch.device) -> Optional[Tensor]:
    """A (3, 3) rotation (numpy or tensor) as float32 on ``device``; None stays None."""
    if rotation is None:
        return None
    refuse_views(rotation, "this path")
    r = torch.as_tensor(rotation, dtype=torch.float32, device=device)
    if r.shape != (3, 3):
        raise ValueError(f"rotation must be (3, 3), got {tuple(r.shape)}")
    return r


def view_count(rotation) -> Optional[int]:
    """V for a ``(V, 3, 3)`` rotation stack, the view axis; None for None
    or for one rotation (whose shape is checked where it is used).

    A stack gives V output views of every image, view v remapped under
    ``rotation[v]``. Raises ``ValueError`` for a three-dimensional shape
    other than ``(V, 3, 3)`` with V >= 1.
    """
    if rotation is None:
        return None
    shape = tuple(rotation.shape) if hasattr(rotation, "shape") else np.shape(rotation)
    if len(shape) != 3:
        return None
    if shape[1:] != (3, 3) or shape[0] < 1:
        raise ValueError(f"a rotation stack (the view axis) must be (V, 3, 3) with V >= 1, "
                         f"got {shape}")
    return int(shape[0])


def refuse_views(rotation, where: str) -> None:
    """Raises ``ValueError`` when ``rotation`` is a ``(V, 3, 3)`` stack:
    ``where`` takes one rotation, and only the full frame has a view axis."""
    views = view_count(rotation)
    if views is not None:
        raise ValueError(f"{where} takes one (3, 3) rotation, not a stack of {views} on the "
                         f"view axis: only the full frame computes views")


def frame_views(rotation, row_offset: int, row_count: Optional[int], out_h: int):
    """(views, row_offset, row_count): ``view_count(rotation)`` and the
    band of ``check_band``; a stack with a band that is not the whole
    frame raises ``ValueError`` (band mode has no view axis)."""
    row_offset, row_count = check_band(row_offset, row_count, out_h)
    views = view_count(rotation)
    if views is not None and (row_offset, row_count) != (0, out_h):
        raise ValueError(f"band mode (rows [{row_offset}, {row_offset + row_count})) takes one "
                         f"(3, 3) rotation, not a stack of {views} on the view axis")
    return views, row_offset, row_count


def source_coords(
    in_lens: LensSpec,
    out_lens: LensSpec,
    in_h: int,
    in_w: int,
    scx: Tensor,
    scy: Tensor,
    rotation: Optional[Tensor],
    out_h: int,
    out_w: int,
):
    """Output-pixel-centered coords -> top-left-aligned source coords.

    The straight-line pipeline of the reference's inner loop body
    (src/reproject.cpp:300-324): unproject, rotate, project, shift.
    """
    vx, vy, vz = projections.target_to_vec(out_lens, float(out_w), float(out_h), scx, scy)
    if rotation is not None:
        r = rotation
        nx = r[0, 0] * vx + r[0, 1] * vy + r[0, 2] * vz
        ny = r[1, 0] * vx + r[1, 1] * vy + r[1, 2] * vz
        nz = r[2, 0] * vx + r[2, 1] * vy + r[2, 2] * vz
        vx, vy, vz = nx, ny, nz
    sx, sy = projections.vec_to_source(in_lens, float(in_w), float(in_h), vx, vy, vz)
    sx = (sx - 0.5) + float(np.float32(in_w * 0.5))
    sy = (sy - 0.5) + float(np.float32(in_h * 0.5))
    return sx, sy


def remap_batch(
    batch: Tensor,
    rotation,
    *,
    in_lens: LensSpec,
    out_lens: LensSpec,
    out_h: int,
    out_w: int,
    interp: str = "bicubic",
    n_samples: int = 1,
    row_offset: int = 0,
    row_count: Optional[int] = None,
) -> Tensor:
    """Reproject ``(..., H_in, W_in, C)`` to ``(..., row_count, out_w, C)``.

    The leading dims are a batch: one coordinate field serves all of its
    images. ``rotation`` is a (3, 3) float32 matrix or None to skip the
    rotate stage (the reference multiplies by identity; results are equal).
    A ``(V, 3, 3)`` stack (``view_count``) gives ``(..., V, out_h, out_w,
    C)``: view v is the remap under ``rotation[v]``, by the same float32
    operations as a call with that one matrix.
    ``row_offset`` / ``row_count`` compute only the band of output rows
    ``[row_offset, row_offset + row_count)`` of the ``out_h x out_w`` frame,
    the unit of the mesh's rows axis (``parallel/batch.py``); the band may
    run past ``out_h``. The defaults give the full frame; a stack takes
    only the full frame.
    """
    views, row_offset, row_count = frame_views(rotation, row_offset, row_count, out_h)
    cols = torch.arange(out_w, device=batch.device)[None, :]
    rows = torch.arange(row_offset, row_offset + row_count, device=batch.device)[:, None]
    kw = dict(in_lens=in_lens, out_lens=out_lens, out_h=out_h, out_w=out_w, interp=interp,
              n_samples=n_samples)
    if views is None:
        return _remap_pixels(batch, rotation, rows, cols, **kw)
    return torch.stack([_remap_pixels(batch, rotation[v], rows, cols, **kw)
                        for v in range(views)], dim=-4)


def check_band(row_offset: int, row_count: Optional[int], out_h: int):
    """(row_offset, row_count) as ints, ``row_count`` None meaning
    ``out_h``; raises on a negative offset or an empty band."""
    row_offset = int(row_offset)
    row_count = out_h if row_count is None else int(row_count)
    if row_offset < 0 or row_count < 1:
        raise ValueError(f"bad band: row_offset={row_offset} must be >= 0 and "
                         f"row_count={row_count} >= 1")
    return row_offset, row_count


def pixel_centres(index: Tensor, size: int) -> Tensor:
    """Output pixel indices -> centred float32 coordinates (src/reproject.cpp:287-288)."""
    return (index.to(torch.float32) + 0.5) - float(np.float32(size * 0.5))


def _remap_pixels(batch, rotation, rows, cols, *, in_lens, out_lens, out_h, out_w, interp,
                  n_samples):
    """Output pixels at (rows, cols), two broadcastable integer index tensors."""
    in_h, in_w = int(batch.shape[-3]), int(batch.shape[-2])
    wrap = wrap_mode_for_input(in_lens)
    rot = rotation_tensor(rotation, batch.device)
    cx = pixel_centres(cols, out_w)
    cy = pixel_centres(rows, out_h)

    offsets = supersample_offsets(n_samples)
    acc = None
    for off_x in offsets:
        for off_y in offsets:
            sx, sy = source_coords(
                in_lens, out_lens, in_h, in_w, cx + off_x, cy + off_y, rot, out_h, out_w
            )
            tap = sampling.sample(batch, sx, sy, interp, wrap)
            acc = tap if acc is None else acc + tap
    return acc * float(np.float32(1.0 / (n_samples * n_samples)))


# Output sub-tile of the list modes and the plan: 8 rows x 128 columns, the
# unit of the JAX package's rescue lists.
TILE_H, TILE_W = 8, 128


def subtile_pixels(tiles: Tensor, row_offset: int = 0):
    """(n, 2) (sub-tile row, sub-tile column) -> pixel rows (n, 8, 1) and columns (n, 1, 128).

    Sub-tile rows count from row ``row_offset`` of the frame (a band's
    first row; 0 for the whole frame), and so do the pixel rows returned:
    ``row_offset`` 0 gives rows of the band, the band's offset gives rows
    of the frame. Pixels past the band's or frame's right and bottom edges
    are included; callers clip them.
    """
    tiles = tiles.to(torch.int64)
    rows = (tiles[:, 0, None, None] * TILE_H + torch.arange(TILE_H, device=tiles.device)[:, None]
            + int(row_offset))
    cols = tiles[:, 1, None, None] * TILE_W + torch.arange(TILE_W, device=tiles.device)
    return rows, cols


def remap_subtiles(
    batch: Tensor,
    rotation,
    tiles: Tensor,
    *,
    in_lens: LensSpec,
    out_lens: LensSpec,
    out_h: int,
    out_w: int,
    interp: str = "bicubic",
    n_samples: int = 1,
    row_offset: int = 0,
) -> Tensor:
    """``remap_batch``'s pixels at the listed 8 x 128 output sub-tiles only.

    ``tiles``: (n, 2) integer (sub-tile row, sub-tile column), the rows
    counted from frame row ``row_offset`` (a band's first row). Returns
    ``(..., n, 8, 128, C)``, computed on those sub-tiles' pixel centres (a
    pixel of band row k at frame row ``row_offset + k``) by the same
    float32 operations as ``remap_batch``, pixels past the edges included.
    """
    rows, cols = subtile_pixels(tiles.to(batch.device), row_offset)
    return _remap_pixels(batch, rotation, rows, cols, in_lens=in_lens, out_lens=out_lens,
                         out_h=out_h, out_w=out_w, interp=interp, n_samples=n_samples)


def scatter_subtiles(out: Tensor, values: Tensor, tiles: Tensor) -> Tensor:
    """Writes ``values`` (B, n, 8, 128, C) into ``out`` (B, H, W, C) at ``tiles``, in place.

    Sub-tile rows count from ``out``'s first row (a band's, for a
    ``(B, band_rows, W, C)`` band). Pixels past ``out``'s right and bottom
    edges are dropped.
    """
    out_h, out_w = int(out.shape[1]), int(out.shape[2])
    rows, cols = subtile_pixels(tiles.to(out.device))
    inside = (rows < out_h) & (cols < out_w)
    flat = (rows * out_w + cols).expand(inside.shape)[inside]
    out.view(out.shape[0], out_h * out_w, out.shape[3])[:, flat] = values[:, inside]
    return out


def remap_image(src: Tensor, rotation, **kwargs) -> Tensor:
    """Reproject one ``(H_in, W_in, C)`` image to ``(row_count, out_w, C)``
    (``row_count`` defaults to ``out_h``); see remap_batch."""
    if src.ndim != 3:
        raise ValueError(f"remap_image takes (H, W, C), got {tuple(src.shape)}")
    return remap_batch(src, rotation, **kwargs)
