"""The sub-tile plan of the planned path (``--rescue`` / ``--split``).

PyTorch port of the list-making part of the JAX package's
``make_prepass(with_rescue=True, split_pieces=2)``
(``ops/pallas/remap_kernel.py:2502-2581``) and
``remap_fused.plan_with_rescue`` (``ops/remap_fused.py:293``). The TPU
tiling, ``suggest_tiling`` and the v5e cost model are not ported.

The output is cut into 8 x 128 sub-tiles (``remap.TILE_H`` x
``remap.TILE_W``). For each sub-tile, and for each of its two 8 x 64
halves, the plan finds the source window its taps read: the row and column
extremes of every tap over every supersample offset, taken from the plain
path's own ``remap.source_coords`` and ``sampling.x_taps`` / ``y_taps``
run on the batch's device (so on a card CUDA's libm, the kernels' libm,
decides the taps), widened by ``SLACK`` texels per side as the JAX
package's ``MARGIN`` is (``remap_kernel.py:73``). For a wrapping input the
column span is circular: the shorter of the spans seen from two cuts of the
circle half a turn apart, so a sub-tile whose taps sit on both sides of the
seam gets one unwrapped window.

The plan sorts the sub-tiles into three disjoint lists that together cover
the grid:

- rescue: the sub-tile's whole window fits ``WINDOW_BUDGET_BYTES`` of
  shared memory; kernel B2 computes it from that window;
- split: the rest, where each half's window fits half the budget; B2's
  split mode computes it from the two windows;
- direct: everything else; B1's list mode computes it with direct taps.

B2 launches each list in size classes (``size_classes``): a CTA reserves
the largest window of its launch, so the plan sorts the rescue and split
lists by the shared memory their windows take when staged
(``staged_floats``) and B2 launches each class with that class's largest.
The classes are cut where one fewer CTA fits an SM's shared memory.

A plan covers the whole frame, or a band of its rows (``row_offset`` /
``row_count``: the unit of the mesh's rows axis, ``parallel/batch.py``),
the counterpart of the JAX package's ``make_prepass(row0=r * band,
band_rows=band)`` inside ``parallel/batch.py::size_rescue_cap``. A band's
sub-tile rows count from its first row, its grid is ``ceil(row_count /
8)`` sub-tile rows, and its rows past ``out_h`` are planned as any other,
as B1's band mode computes them. Bands of a frame do not cut its sub-tiles
where they lie (540 rows are 67.5 sub-tiles), so each band is planned at
its own rows, as JAX makes one prepass a band.

The plan depends only on the configuration, not on pixel data, so a frame
stream computes it once (``pipeline.process_batch`` caches it).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..models.lens import LensSpec, wrap_mode_for_input
from . import remap, sampling

Tensor = torch.Tensor

TILE_H, TILE_W = remap.TILE_H, remap.TILE_W
SLACK = 1
# Dynamic shared memory one B2 CTA may stage. Hopper gives a block up to
# 227 KB with the opt-in attribute; 96 KB lets two CTAs share an SM.
WINDOW_BUDGET_BYTES = 96 * 1024

# An H100 SM's shared memory, and what the runtime reserves of it a CTA.
SM_SHARED_BYTES = 228 * 1024
CTA_RESERVED_BYTES = 1024
# The size classes: a class's windows take at most the bytes that let this
# many CTAs share an SM; the last class takes the rest. B2's registers
# already cap it at 4 CTAs an SM (__launch_bounds__(256, 4) in
# csrc/rescue_windows.cu), so smaller classes would add launches, not CTAs.
CLASS_CTAS_PER_SM = (4, 3)
CLASS_LIMITS = tuple(SM_SHARED_BYTES // k - CTA_RESERVED_BYTES for k in CLASS_CTAS_PER_SM)

# Rescue entries: (sub-tile row, sub-tile column, row0, rows, col0, cols);
# split entries add (row0, rows, col0, cols) of the right half; direct
# entries are (sub-tile row, sub-tile column). csrc/rescue_kernel.cu reads
# the same layout.
RESCUE_WIDTH, SPLIT_WIDTH = 6, 10

_FAR = 1 << 40  # beyond any texel index: the neutral value of the extremes


@dataclasses.dataclass(frozen=True)
class Plan:
    """Three disjoint int32 lists on the batch's device, covering the sub-tile grid
    of the band ``band`` of the frame (the whole frame: ``(0, out_h)``)."""

    grid: Tuple[int, int]  # (sub-tile rows, sub-tile columns)
    frame: Tuple[int, int]  # (out_h, out_w) of the frame the band lies in
    band: Tuple[int, int]  # (first frame row, rows): sub-tile rows count from the first
    source_shape: Tuple[int, int, int]  # (in_h, in_w, C) the windows were sized for
    rescue: Tensor  # (n, 6)
    split: Tensor  # (n, 10)
    direct: Tensor  # (n, 2)
    # (count, largest staged float32 values an image) of each size class,
    # in list order: B2 launches each class with its largest.
    rescue_classes: Tuple[Tuple[int, int], ...]
    split_classes: Tuple[Tuple[int, int], ...]

    def sizes(self) -> dict:
        return {"rescue": int(self.rescue.shape[0]), "split": int(self.split.shape[0]),
                "direct": int(self.direct.shape[0])}


def _extremes(rotation, *, in_lens, out_lens, in_h, in_w, out_h, out_w, interp, n_samples,
              device, row_offset, row_count) -> Tensor:
    """Per 8 x 64 half of every sub-tile of the band: (6, n_ty, n_tx, 2)
    int64 minima of rows, -rows, cols, -cols, cols', -cols', with cols' the
    columns seen from the cut half a turn away, ``(col + in_w // 2) % in_w``."""
    wrap = wrap_mode_for_input(in_lens)
    rot = remap.rotation_tensor(rotation, device)
    n_ty, n_tx = -(-row_count // TILE_H), -(-out_w // TILE_W)
    cx = remap.pixel_centres(torch.arange(out_w, device=device), out_w)[None, :]
    rows = torch.arange(row_offset, row_offset + row_count, device=device)
    cy = remap.pixel_centres(rows, out_h)[:, None]
    half = in_w // 2
    ext = None
    for off_x in remap.supersample_offsets(n_samples):
        for off_y in remap.supersample_offsets(n_samples):
            sx, sy = remap.source_coords(in_lens, out_lens, in_h, in_w, cx + off_x, cy + off_y,
                                         rot, out_h, out_w)
            sx, sy = (t.expand(row_count, out_w) for t in torch.broadcast_tensors(sx, sy))
            cols = torch.stack(sampling.x_taps(sx, in_w, interp, wrap).idx)
            rows = torch.stack(sampling.y_taps(sy, in_h, interp).idx)
            cols2 = (cols + half) % in_w
            e = torch.stack([rows.amin(0), -rows.amax(0), cols.amin(0), -cols.amax(0),
                             cols2.amin(0), -cols2.amax(0)])
            ext = e if ext is None else torch.minimum(ext, e)
    padded = torch.full((6, n_ty * TILE_H, n_tx * TILE_W), _FAR, dtype=torch.int64, device=device)
    padded[:, :row_count, :out_w] = ext
    return padded.view(6, n_ty, TILE_H, n_tx, 2, TILE_W // 2).amin(dim=(2, 5))


def _windows(ext: Tensor, in_h: int, in_w: int, wrap: bool) -> Tensor:
    """Extremes (6, ...) -> windows (..., 4) int64 of (row0, rows, col0, cols)."""
    rmin, rmax = ext[0], -ext[1]
    row0 = (rmin - SLACK).clamp(min=0)
    rows = (rmax + SLACK).clamp(max=in_h - 1) - row0 + 1
    if wrap:
        span1 = -ext[3] - ext[2]
        span2 = -ext[5] - ext[4]
        start = torch.where(span1 <= span2, ext[2], (ext[4] - in_w // 2) % in_w)
        cols = torch.minimum(span1, span2) + 1 + 2 * SLACK
        col0 = (start - SLACK) % in_w
        whole_row = cols >= in_w
        col0 = torch.where(whole_row, 0, col0)
        cols = torch.where(whole_row, in_w, cols)
    else:
        col0 = (ext[2] - SLACK).clamp(min=0)
        cols = (-ext[3] + SLACK).clamp(max=in_w - 1) - col0 + 1
    win = torch.stack([row0, rows, col0, cols], dim=-1)
    # A half that lies wholly past the frame's right edge has no taps.
    empty = torch.tensor([0, 1, 0, 1], dtype=win.dtype, device=win.device)
    return torch.where((rmin <= rmax)[..., None], win, empty)


def windows(rotation, *, in_lens: LensSpec, out_lens: LensSpec, in_h: int, in_w: int,
            out_h: int, out_w: int, interp: str = "bicubic", n_samples: int = 1,
            device="cuda", row_offset: int = 0,
            row_count: Optional[int] = None) -> Tuple[Tensor, Tensor]:
    """The source windows of every sub-tile and of its two halves, in the
    band of rows ``[row_offset, row_offset + row_count)`` of the frame (by
    default all ``out_h``).

    Returns ``(whole, halves)``: int64 ``(n_ty, n_tx, 4)`` and
    ``(n_ty, n_tx, 2, 4)`` of (row0, rows, col0, cols), sub-tile row 0 at
    the band's first row. The windows are in the whole source's
    coordinates: ``col0`` lies in ``[0, in_w)``; for a wrapping input the
    window's columns continue past ``in_w`` at column 0. Computed on the
    card unless ``device`` says otherwise.
    """
    device = torch.device(device)
    row_offset, row_count = remap.check_band(row_offset, row_count, out_h)
    ext = _extremes(rotation, in_lens=in_lens, out_lens=out_lens, in_h=in_h, in_w=in_w,
                    out_h=out_h, out_w=out_w, interp=interp, n_samples=n_samples, device=device,
                    row_offset=row_offset, row_count=row_count)
    wrap = wrap_mode_for_input(in_lens)
    halves = _windows(ext, in_h, in_w, wrap)
    whole = _windows(ext.amin(dim=-1), in_h, in_w, wrap)
    return whole, halves


def staged_floats(win: Tensor, channels: int) -> Tensor:
    """The float32 values windows ``(..., 4)`` of (row0, rows, col0, cols)
    may take in B2's shared memory: each row copied from the 16-byte boundary
    at or below its first value and rounded up to 16 bytes, so
    ``rows * round_up(cols * C + 3, 4)``."""
    return win[..., 1] * ((win[..., 3] * channels + 6) // 4 * 4)


def size_classes(entries: Tensor, channels: int) -> Tuple[Tensor, Tuple[Tuple[int, int], ...]]:
    """A rescue or split list sorted by size class, and its classes.

    Each entry's windows (one, or a split entry's two) take
    ``staged_floats`` an image; its class is the first of ``CLASS_LIMITS``
    that holds those bytes, or the last class. Returns the entries sorted by
    class (stable: list order within a class) and ``(count, largest staged
    floats)`` of each non-empty class, in that order.
    """
    n, width = (int(d) for d in entries.shape)
    windows = entries[:, 2:].to(torch.int64).view(n, (width - 2) // 4, 4)
    staged = staged_floats(windows, channels).sum(-1)
    limits = torch.tensor(CLASS_LIMITS, dtype=torch.int64, device=entries.device)
    cls = torch.bucketize(4 * staged, limits)
    order = torch.sort(cls, stable=True).indices
    n_cls = len(CLASS_LIMITS) + 1
    counts = torch.bincount(cls, minlength=n_cls)
    largest = torch.zeros(n_cls, dtype=torch.int64, device=entries.device).scatter_reduce(
        0, cls, staged, "amax")
    classes = tuple((int(c), int(f)) for c, f in zip(counts.tolist(), largest.tolist()) if c)
    return entries[order].contiguous(), classes


def make_plan(
    rotation,
    *,
    in_lens: LensSpec,
    out_lens: LensSpec,
    in_h: int,
    in_w: int,
    channels: int,
    out_h: int,
    out_w: int,
    interp: str = "bicubic",
    n_samples: int = 1,
    split: bool = True,
    device="cuda",
    budget_bytes: int = WINDOW_BUDGET_BYTES,
    row_offset: int = 0,
    row_count: Optional[int] = None,
) -> Plan:
    """The rescue, split and direct lists of one configuration, over the
    band of rows ``[row_offset, row_offset + row_count)`` of the frame (by
    default the whole frame).

    ``split=False`` leaves the split list empty: what would go there goes
    direct. The lists are made on, and lie on, ``device``: the card unless
    the caller asks for another (the batch's device, in the pipeline).
    """
    device = torch.device(device)
    row_offset, row_count = remap.check_band(row_offset, row_count, out_h)
    whole, halves = windows(rotation, in_lens=in_lens, out_lens=out_lens, in_h=in_h, in_w=in_w,
                            out_h=out_h, out_w=out_w, interp=interp, n_samples=n_samples,
                            device=device, row_offset=row_offset, row_count=row_count)
    n_ty, n_tx = int(whole.shape[0]), int(whole.shape[1])
    budget = budget_bytes // 4  # float32 values
    whole_floats = whole[..., 1] * whole[..., 3] * channels
    half_floats = halves[..., 1] * halves[..., 3] * channels
    fits = whole_floats <= budget
    split_fits = ~fits & (half_floats <= budget // 2).all(dim=-1)
    if not split:
        split_fits = torch.zeros_like(fits)
    direct = ~fits & ~split_fits
    ty, tx = torch.meshgrid(torch.arange(n_ty, device=device), torch.arange(n_tx, device=device),
                            indexing="ij")
    tile = torch.stack([ty, tx], dim=-1)

    def entries(mask: Tensor, *fields: Tensor) -> Tensor:
        n = int(mask.sum())
        cols = [tile[mask]] + [f[mask].reshape(n, f[0, 0].numel()) for f in fields]
        return torch.cat(cols, dim=1).to(torch.int32).contiguous()

    rescue, rescue_classes = size_classes(entries(fits, whole), channels)
    split_list, split_classes = size_classes(entries(split_fits, halves), channels)
    return Plan(
        grid=(n_ty, n_tx),
        frame=(out_h, out_w),
        band=(row_offset, row_count),
        source_shape=(in_h, in_w, channels),
        rescue=rescue,
        split=split_list,
        direct=entries(direct),
        rescue_classes=rescue_classes,
        split_classes=split_classes,
    )


def check(plan: Plan, batch: Tensor, out_h: int, out_w: int, row_offset: int = 0,
          row_count: Optional[int] = None) -> None:
    """A plan serves only the source shape, output size, band of rows and
    device it was made for."""
    shape = tuple(int(d) for d in batch.shape[1:])
    if plan.frame != (out_h, out_w) or plan.source_shape != shape:
        raise ValueError(f"plan for a {plan.source_shape} source and the sub-tile grid of a "
                         f"{plan.frame} frame, given a {shape} source and a {(out_h, out_w)} "
                         f"frame")
    band = remap.check_band(row_offset, row_count, out_h)
    if plan.band != band:
        raise ValueError(f"plan for rows [{plan.band[0]}, {sum(plan.band)}), given the band "
                         f"[{band[0]}, {sum(band)})")
    if plan.rescue.device != batch.device:
        raise ValueError(f"plan on {plan.rescue.device}, batch on {batch.device}")


def misses_plain(batch: Tensor, rotation, entries: Tensor, *, split: bool, in_lens: LensSpec,
                 out_lens: LensSpec, out_h: int, out_w: int, interp: str,
                 n_samples: int, row_offset: int = 0,
                 row_count: Optional[int] = None) -> Tensor:
    """Reads outside their windows that B2 would count, for listed ``entries``
    of the band ``[row_offset, row_offset + row_count)`` (by default the
    whole frame).

    Counts as B2's counter does: every (row tap, column tap) pair of every
    channel, supersample offset, image and pixel inside the band whose row
    or column lies outside the pixel's window. Returns a 0-d int64 tensor.
    """
    b, in_h, in_w, c = (int(d) for d in batch.shape)
    row_offset, row_count = remap.check_band(row_offset, row_count, out_h)
    wrap = wrap_mode_for_input(in_lens)
    device = batch.device
    entries = entries.to(device=device, dtype=torch.int64)
    rows, cols = remap.subtile_pixels(entries[:, :2])
    inside = ((rows < row_count) & (cols < out_w))
    # The window of each pixel: the whole sub-tile's, or its half's.
    win = entries[:, 2:6, None, None]
    if split:
        right = (torch.arange(TILE_W, device=device) >= TILE_W // 2)[None, None, :]
        win = torch.where(right, entries[:, 6:10, None, None], win)
    row0, nrows, col0, ncols = win[:, 0], win[:, 1], win[:, 2], win[:, 3]
    rot = remap.rotation_tensor(rotation, device)
    cx = remap.pixel_centres(cols, out_w)
    cy = remap.pixel_centres(rows + row_offset, out_h)
    total = torch.zeros((), dtype=torch.int64, device=device)
    for off_x in remap.supersample_offsets(n_samples):
        for off_y in remap.supersample_offsets(n_samples):
            sx, sy = remap.source_coords(in_lens, out_lens, in_h, in_w, cx + off_x, cy + off_y,
                                         rot, out_h, out_w)
            x_in = [_inside(i - col0, ncols, in_w if wrap else None)
                    for i in sampling.x_taps(sx, in_w, interp, wrap).idx]
            y_in = [_inside(i - row0, nrows, None) for i in sampling.y_taps(sy, in_h, interp).idx]
            k = len(x_in)
            good = sum(x_in).to(torch.int64) * sum(y_in).to(torch.int64)
            total += ((k * k - good) * inside).sum()
    return total * (b * c)


def _inside(local: Tensor, size: Tensor, wrap_w: Optional[int]) -> Tensor:
    if wrap_w is not None:
        local = torch.where(local < 0, local + wrap_w, local)
    return (local >= 0) & (local < size)
