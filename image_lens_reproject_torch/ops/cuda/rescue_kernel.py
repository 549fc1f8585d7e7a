"""Wrapper of kernel B2 (``csrc/rescue_kernel.cu``, ``csrc/rescue_windows.cu``):
listed sub-tiles from source windows staged in shared memory.

``remap_windows`` writes the listed 8 x 128 output sub-tiles of an existing
``(B, out_h, out_w, C)`` output in place, each computed from its own source
window (``split=False``, the JAX package's K2) or from one window for each
8 x 64 half (``split=True``, K3). In band mode (``row_offset`` /
``row_count``, B1's band mode) the output is a ``(B, row_count, out_w,
C)`` band of the frame's rows and the sub-tile rows count from its first,
as K2 ran at a mesh band's ``row0``; the windows stay in the whole
source's coordinates. The lists, their windows and their size
classes come from ``ops/plan.py``: B2 is launched once for each size class,
reserving that class's largest window, and a CTA computes the whole batch
where the batch's windows fit ``GROUP_BYTES`` (``images_per_cta``), else
one image. Its instance follows B1's rule (``specialisation``).

A CPU tensor goes to the plain version, ``remap_windows_plain``: B1 list
mode's plain version (the pixels computed on the listed sub-tiles' centres
with ``remap.source_coords`` and ``sampling.sample``, then scattered), plus
the count of reads that fall outside their windows. A CUDA tensor launches
B2 or raises. Reads outside a window add to ``misses``, a one-element int64
tensor on the batch's device that the caller owns and checks.

``build.COUNTS`` counts the wrapper calls that launched B2 (each launches
one kernel a size class) under ``b2.frame``, ``b2.band`` (a band that is
not the whole frame) and ``b2.split``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ...models.lens import LensSpec
from .. import plan as plan_mod
from . import build
from . import remap_kernel as B1

LIBRARY = "ilr_rescue"
# The entry points, and the kernel compiled once for each input lens (its
# LensCode), all at once (build.py).
SOURCES = ("rescue_kernel.cu",) + tuple(
    ("rescue_windows.cu", (f"ILR_IN_LENS={code}",)) for code in range(5))
_P, _I, _PARAMS = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(B1.RemapParams)
# The entry points of csrc/rescue_kernel.cu (build.bind).
SIGNATURES = {
    # src, dst, rotation, entries, n_entries, split, window_bytes, images,
    # params, misses, device, stream
    "ilr_remap_windows": [_P, _P, _P, _P, _I, _I, _I, _I, _PARAMS, _P, _I, _P],
    "ilr_params_size": [],
}
_COUNTS = build.counters("b2.frame", "b2.band", "b2.split")
# Hopper's largest dynamic shared memory per block, with the opt-in attribute.
MAX_SHARED_BYTES = 227 * 1024
# A CTA computes every image of the batch, its coordinates computed once for
# all, when the batch's windows take at most this much shared memory: the
# smallest size class's, so that grouping never holds more shared memory a
# CTA than that class's one-image CTAs.
GROUP_BYTES = plan_mod.CLASS_LIMITS[0]

# B2's instance (channel count, supersample count) is B1's:
# C = 3, or 4 from an aligned source, with 32-bit offsets; one supersample.
specialisation = B1.specialisation


def images_per_cta(batch: int, window_bytes: int) -> int:
    """The images one CTA computes: the whole batch where its windows
    (``window_bytes`` an image) fit ``GROUP_BYTES``, else 1."""
    return batch if batch * window_bytes <= GROUP_BYTES else 1


def new_misses(device) -> torch.Tensor:
    """A zeroed out-of-window read counter for ``device``."""
    return torch.zeros(1, dtype=torch.int64, device=device)


def remap_windows_plain(
    batch: torch.Tensor,
    rotation,
    out: torch.Tensor,
    entries: torch.Tensor,
    *,
    split: bool,
    misses: torch.Tensor,
    in_lens: LensSpec,
    out_lens: LensSpec,
    out_h: int,
    out_w: int,
    interp: str = "bicubic",
    n_samples: int = 1,
    exposure: float = 1.0,
    reinhard: float = 1.0,
    classes=(),
    row_offset: int = 0,
    row_count: Optional[int] = None,
) -> torch.Tensor:
    """The plain version of B2, on whatever device ``batch`` lies.

    ``classes`` sizes B2's launches and plays no part here.
    """
    band = dict(row_offset=row_offset, row_count=row_count)
    misses += plan_mod.misses_plain(
        batch, rotation, entries, split=split, in_lens=in_lens, out_lens=out_lens,
        out_h=out_h, out_w=out_w, interp=interp, n_samples=n_samples, **band,
    )
    return B1.remap_tonemap_list_plain(
        batch, rotation, out, entries[:, :2], in_lens=in_lens, out_lens=out_lens,
        out_h=out_h, out_w=out_w, interp=interp, n_samples=n_samples,
        exposure=exposure, reinhard=reinhard, **band,
    )


@functools.cache
def library() -> ctypes.CDLL:
    """B2's shared library, built from ``csrc/`` by nvcc at the first call."""
    return build.check_params(build.bind(build.load(LIBRARY, SOURCES), SIGNATURES),
                              B1.RemapParams)


def remap_windows(
    batch: torch.Tensor,
    rotation,
    out: torch.Tensor,
    entries: torch.Tensor,
    *,
    split: bool,
    misses: torch.Tensor,
    in_lens: LensSpec,
    out_lens: LensSpec,
    out_h: int,
    out_w: int,
    interp: str = "bicubic",
    n_samples: int = 1,
    exposure: float = 1.0,
    reinhard: float = 1.0,
    classes=(),
    row_offset: int = 0,
    row_count: Optional[int] = None,
) -> torch.Tensor:
    """Writes the listed sub-tiles of ``out`` from their windows, in place.

    ``entries``: ``(n, 6)`` int32, or ``(n, 10)`` with ``split``, sorted by
    size class; ``classes``: ``(count, staged float32 values an image)`` of
    each class in list order (``Plan.rescue_classes`` / ``split_classes``,
    or ``plan.size_classes`` for another list). ``row_offset`` /
    ``row_count``: the band of the frame's rows that ``out`` holds and the
    entries' sub-tile rows count in (by default the whole frame). A CPU
    tensor runs the plain version; a CUDA tensor launches B2 on the current
    stream of its device, once a class, or raises. Returns ``out``.
    """
    kw = dict(in_lens=in_lens, out_lens=out_lens, out_h=out_h, out_w=out_w,
              interp=interp, n_samples=n_samples, exposure=exposure, reinhard=reinhard,
              row_offset=row_offset, row_count=row_count)
    if batch.device.type == "cpu":
        return remap_windows_plain(batch, rotation, out, entries, split=split, misses=misses,
                                   classes=classes, **kw)
    p, rot, stream = B1.launch_setup("remap_windows", batch, rotation, **kw)
    B1.check_output("remap_windows", out, batch, p)
    width = plan_mod.SPLIT_WIDTH if split else plan_mod.RESCUE_WIDTH
    B1.check_list("remap_windows", entries, batch, width)
    if misses.shape != (1,) or misses.dtype != torch.int64 or misses.device != batch.device:
        raise ValueError(f"remap_windows: misses must be a (1,) int64 tensor on {batch.device}")
    if entries.shape[0] == 0:
        return out
    if sum(count for count, _ in classes) != entries.shape[0]:
        raise ValueError(f"remap_windows: classes {classes} do not cover the "
                         f"{entries.shape[0]} entries")
    for _, floats in classes:
        if not 0 < 4 * floats <= MAX_SHARED_BYTES:
            raise ValueError(f"remap_windows: window of {4 * floats} bytes, not in "
                             f"(0, {MAX_SHARED_BYTES}]")
    lib = library()
    start = 0
    for count, floats in classes:
        images = images_per_cta(p.batch, 4 * floats)
        rc = lib.ilr_remap_windows(
            batch.data_ptr(), out.data_ptr(), None if rot is None else rot.data_ptr(),
            entries[start].data_ptr(), count, int(split), 4 * floats, images, ctypes.byref(p),
            misses.data_ptr(), batch.device.index, stream,
        )
        build.raise_on_error(lib, rc, "rescue kernel")
        start += count
    _COUNTS["b2.split" if split else "b2.frame" if (p.row0, p.band_rows) == (0, out_h)
            else "b2.band"] += 1
    return out
