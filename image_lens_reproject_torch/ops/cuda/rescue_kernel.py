"""Wrapper of kernel B2 (``csrc/rescue_kernel.cu``): listed sub-tiles from
source windows staged in shared memory.

``remap_windows`` writes the listed 8 x 128 output sub-tiles of an existing
``(B, out_h, out_w, C)`` output in place, each computed from its own source
window (``split=False``, the JAX package's K2) or from one window for each
8 x 64 half (``split=True``, K3). The lists and windows come from
``ops/plan.py``.

A CPU tensor goes to the plain version, ``remap_windows_plain``: B1 list
mode's plain version (the pixels computed on the listed sub-tiles' centres
with ``remap.source_coords`` and ``sampling.sample``, then scattered), plus
the count of reads that fall outside their windows. A CUDA tensor launches
B2 or raises. Reads outside a window add to ``misses``, a one-element int64
tensor on the batch's device that the caller owns and checks.

``LAUNCHES`` and ``SPLIT_LAUNCHES`` count the launches of each mode.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ...models.lens import LensSpec
from .. import plan as plan_mod
from . import build
from . import remap_kernel as B1

SOURCES = ("rescue_kernel.cu",)
LAUNCHES = 0
SPLIT_LAUNCHES = 0
# Hopper's largest dynamic shared memory per block, with the opt-in attribute.
MAX_SHARED_BYTES = 227 * 1024


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
    window_floats: int = 0,
) -> torch.Tensor:
    """The plain version of B2, on whatever device ``batch`` lies.

    ``window_floats`` is B2's shared-memory size and plays no part here.
    """
    misses += plan_mod.misses_plain(
        batch, rotation, entries, split=split, in_lens=in_lens, out_lens=out_lens,
        out_h=out_h, out_w=out_w, interp=interp, n_samples=n_samples,
    )
    return B1.remap_tonemap_list_plain(
        batch, rotation, out, entries[:, :2], in_lens=in_lens, out_lens=out_lens,
        out_h=out_h, out_w=out_w, interp=interp, n_samples=n_samples,
        exposure=exposure, reinhard=reinhard,
    )


@functools.cache
def library() -> ctypes.CDLL:
    """B2's shared library, built from ``csrc/`` by nvcc at the first call."""
    lib = build.load("ilr_rescue", SOURCES)
    lib.ilr_remap_windows.restype = ctypes.c_int
    lib.ilr_remap_windows.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(B1.RemapParams), ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p,
    ]
    return build.check_params(lib, B1.RemapParams)


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
    window_floats: int = 0,
) -> torch.Tensor:
    """Writes the listed sub-tiles of ``out`` from their windows, in place.

    ``entries``: ``(n, 6)`` int32, or ``(n, 10)`` with ``split``, from
    ``ops/plan.py``; ``window_floats``: the largest window (pair) of the
    list in float32 values (``Plan.rescue_floats`` / ``split_floats``).
    A CPU tensor runs the plain version; a CUDA tensor launches B2 on the
    current stream of its device, or raises. Returns ``out``.
    """
    global LAUNCHES, SPLIT_LAUNCHES
    kw = dict(in_lens=in_lens, out_lens=out_lens, out_h=out_h, out_w=out_w,
              interp=interp, n_samples=n_samples, exposure=exposure, reinhard=reinhard)
    if batch.device.type == "cpu":
        return remap_windows_plain(batch, rotation, out, entries, split=split, misses=misses,
                                   window_floats=window_floats, **kw)
    p, rot, stream = B1.launch_setup("remap_windows", batch, rotation, **kw)
    B1.check_output("remap_windows", out, batch, out_h, out_w)
    width = plan_mod.SPLIT_WIDTH if split else plan_mod.RESCUE_WIDTH
    B1.check_list("remap_windows", entries, batch, width)
    if misses.shape != (1,) or misses.dtype != torch.int64 or misses.device != batch.device:
        raise ValueError(f"remap_windows: misses must be a (1,) int64 tensor on {batch.device}")
    if entries.shape[0] == 0:
        return out
    smem_bytes = 4 * int(window_floats)
    if not 0 < smem_bytes <= MAX_SHARED_BYTES:
        raise ValueError(f"remap_windows: window of {smem_bytes} bytes, not in "
                         f"(0, {MAX_SHARED_BYTES}]")
    lib = library()
    rc = lib.ilr_remap_windows(
        batch.data_ptr(), out.data_ptr(), None if rot is None else rot.data_ptr(),
        entries.data_ptr(), int(entries.shape[0]), int(split), smem_bytes, ctypes.byref(p),
        misses.data_ptr(), batch.device.index, stream,
    )
    build.raise_on_error(lib, rc, "rescue kernel")
    if split:
        SPLIT_LAUNCHES += 1
    else:
        LAUNCHES += 1
    return out
