"""Probe: windows of a source fetched at dynamic offsets, single and double-buffered.

Port of the JAX package's ``bench/dma_probe.py``. Two functions of a
``(h, w)`` float32 source and an ``(n, 2)`` int32 table of window starts
``(r0, c0)``, each with its kernel in ``csrc/dma_probe.cu``:

- ``window_copy`` (replaces K4, ``build``): ``out[t] = 2 *
  src[r0 : r0+16, c0 : c0+128]``;
- ``window_scan_db`` (replaces K5, ``build_db``): ``out[t] = sum over s <
  n_steps of src[r0+8s : +16, c0+128s : +128]``, summed from 0 in the order
  s = 0, 1, ...; the kernel reads the windows straight into registers
  through L1, 4 steps' loads in flight at once, whatever the source's base
  and width. It keeps the JAX probe's name, but stages nothing: it prices
  reading the windows, not fetching them into shared memory.

A window's start below 0 counts from the end, as Python indexing does, and
is then clamped so that the window lies inside ``src``: what the JAX
kernels read in interpret mode. A CPU tensor runs the plain version; a
CUDA tensor launches the kernel or raises. ``build.COUNTS`` counts the
kernels' launches (``probes.window_copy``, ``probes.window_scan_db``).

``python -m image_lens_reproject_torch.probes.dma_probe [--device cpu]``
checks both against numpy on the probe's 64 tiles (OK / FAIL), then on the
card times 2048 tiles: ns per tile, and ns per step of the 4-step scan.
"""

from __future__ import annotations

import sys
from typing import Optional, Sequence

import numpy as np
import torch

from . import NOT_MEASURED, expect, launch, loop_ms, parse_args

H_WIN, W_WIN = 16, 128  # the window (rows, columns)
ROW_STEP = 8  # rows the scan's window moves down a step (it moves W_WIN columns right)

H, W = 512, 1024  # the probe's source
N_TILES, BIG_TILES, N_STEPS = 64, 2048, 4
# Starts past every edge of the probe's source, moved into it as the
# interpret mode moves them: below 0 they count from the end, then clamp.
EDGE_OFFS = np.array([[500, 1000], [-8, -3], [0, 0], [496, 896], [8, 1020], [-600, 2000]],
                     np.int32)
# Step counts and source layouts the scan's kernel is held to its plain
# version on: 7 runs past the kernel's unroll of 4; a width that is no
# multiple of 4 and a base 4 bytes past a 16-byte boundary start its rows
# off 16-byte boundaries.
EDGE_STEPS = (1, 2, 4, 7)
EDGE_SOURCES = ("aligned", "odd width", "unaligned base")


def _check(name: str, src: torch.Tensor, offs: torch.Tensor) -> None:
    expect(name, src, "src", torch.float32, 2)
    expect(name, offs, "offs", torch.int32, 2, src.device)
    h, w = src.shape
    if h < H_WIN or w < W_WIN or offs.shape[1] != 2:
        raise ValueError(f"{name}: src {tuple(src.shape)} must be at least ({H_WIN}, {W_WIN}) "
                         f"and offs (n, 2), got offs {tuple(offs.shape)}")


def windows(src: torch.Tensor, offs: torch.Tensor, step: int) -> torch.Tensor:
    """(n, 16, 128): the windows of scan step ``step``, their starts moved
    into ``src``, a 2-d tensor of any type."""
    h, w = src.shape

    def start(first: torch.Tensor, size: int, win: int) -> torch.Tensor:
        return torch.where(first < 0, first + size, first).clamp(0, size - win)

    r = start(offs[:, 0].long() + ROW_STEP * step, h, H_WIN)
    c = start(offs[:, 1].long() + W_WIN * step, w, W_WIN)
    rows = r[:, None] + torch.arange(H_WIN, device=src.device)
    cols = c[:, None] + torch.arange(W_WIN, device=src.device)
    return src[rows[:, :, None], cols[:, None, :]]


def window_copy_plain(src: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of ``window_copy``, on whatever device ``src`` lies."""
    return windows(src, offs, 0) * 2.0


def window_scan_db_plain(src: torch.Tensor, offs: torch.Tensor, n_steps: int) -> torch.Tensor:
    """The plain PyTorch version of ``window_scan_db``, on whatever device ``src`` lies."""
    acc = torch.zeros((offs.shape[0], H_WIN, W_WIN), dtype=src.dtype, device=src.device)
    for s in range(n_steps):
        acc = acc + windows(src, offs, s)
    return acc


def window_copy(src: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """``(h, w)`` float32, ``(n, 2)`` int32 -> ``(n, 16, 128)``: twice each window."""
    _check("window_copy", src, offs)
    if src.device.type == "cpu":
        return window_copy_plain(src, offs)
    n = int(offs.shape[0])
    out = torch.empty((n, H_WIN, W_WIN), dtype=torch.float32, device=src.device)
    if n:
        launch("ilr_window_copy", src, src.data_ptr(), int(src.shape[0]), int(src.shape[1]),
               offs.data_ptr(), n, out.data_ptr())
    return out


def window_scan_db(src: torch.Tensor, offs: torch.Tensor, n_steps: int) -> torch.Tensor:
    """``(h, w)`` float32, ``(n, 2)`` int32 -> ``(n, 16, 128)``: each tile's
    ``n_steps`` windows summed."""
    _check("window_scan_db", src, offs)
    if n_steps < 1:
        raise ValueError(f"window_scan_db: n_steps must be at least 1, got {n_steps}")
    if src.device.type == "cpu":
        return window_scan_db_plain(src, offs, n_steps)
    n = int(offs.shape[0])
    out = torch.empty((n, H_WIN, W_WIN), dtype=torch.float32, device=src.device)
    if n:
        launch("ilr_window_scan_db", src, src.data_ptr(), int(src.shape[0]), int(src.shape[1]),
               offs.data_ptr(), n, int(n_steps), out.data_ptr())
    return out


def check_inputs():
    """The probe's check inputs, drawn as ``bench/dma_probe.py`` draws them:
    (rng, src (H, W), offs (64, 2), offs_db (64, 2)); the rng goes on to
    draw the timing table."""
    rng = np.random.default_rng(0)
    src = rng.random((H, W), np.float32)
    offs = np.stack([rng.integers(0, H - H_WIN - 64, N_TILES),
                     rng.integers(0, W - W_WIN - 64, N_TILES)], axis=1).astype(np.int32)
    offs[:, 0] = (offs[:, 0] // 8) * 8
    # Start columns that are not multiples of 4: no 16-byte copy fits them.
    offs[0] = (8, 5)
    offs[1] = (16, 129)
    offs_db = offs.copy()
    offs_db[:, 0] = np.minimum(offs_db[:, 0], H - H_WIN - ROW_STEP * N_STEPS) // 8 * 8
    offs_db[:, 1] = np.minimum(offs_db[:, 1], W - N_STEPS * W_WIN)
    return rng, src, offs, offs_db


def edge_source(src: torch.Tensor, layout: str) -> torch.Tensor:
    """``src`` (h, w), laid out as ``layout`` of ``EDGE_SOURCES`` says: as
    it is, cut to a width of w - 3, or copied to a base 4 bytes past the
    16-byte boundary of a new allocation."""
    if layout == "odd width":
        return src[:, :src.shape[1] - 3].contiguous()
    if layout == "unaligned base":
        return torch.cat([src.new_zeros(1), src.reshape(-1)])[1:].view(src.shape)
    if layout != "aligned":
        raise ValueError(f"edge_source: layout {layout!r} not in {EDGE_SOURCES}")
    return src


def timing_table(rng) -> np.ndarray:
    """The probe's (2048, 2) timing table: every scan of it stays inside the source."""
    return np.stack([rng.integers(0, H - H_WIN - 64, BIG_TILES),
                     rng.integers(0, W - N_STEPS * W_WIN, BIG_TILES)], axis=1).astype(np.int32)


def main(argv: Optional[Sequence[str]] = None) -> int:
    dev = parse_args(argv, "Windows fetched at dynamic offsets: checks, then times on the card.")
    rng, src, offs, offs_db = check_inputs()
    src_t = torch.from_numpy(src).to(dev)

    out = window_copy(src_t, torch.from_numpy(offs).to(dev)).cpu().numpy()
    want = np.stack([2.0 * src[r:r + H_WIN, c:c + W_WIN] for r, c in offs])
    err = float(np.abs(out - want).max())
    ok = err == 0
    print(f"simple DMA window: max err {err:.2e} {'OK' if err == 0 else 'FAIL'}")

    out = window_scan_db(src_t, torch.from_numpy(offs_db).to(dev), N_STEPS).cpu().numpy()
    want = np.stack([
        sum(src[r + s * ROW_STEP:r + s * ROW_STEP + H_WIN, c + s * W_WIN:c + (s + 1) * W_WIN]
            for s in range(N_STEPS))
        for r, c in offs_db
    ])
    err = float(np.abs(out - want).max())
    ok &= err < 1e-5
    print(f"double-buffered scan: max err {err:.2e} {'OK' if err < 1e-5 else 'FAIL'}")

    if dev.type == "cpu":
        print(NOT_MEASURED)
    else:
        offs_b = torch.from_numpy(timing_table(rng)).to(dev)
        ms = loop_ms(lambda: window_copy(src_t, offs_b), warmup=3, reps=10)
        print(f"1-DMA tile: {ms * 1e6 / BIG_TILES:.0f} ns/tile ({BIG_TILES} tiles)")
        ms = loop_ms(lambda: window_scan_db(src_t, offs_b, N_STEPS), warmup=3, reps=10)
        print(f"double-buffered: {ms * 1e6 / BIG_TILES / N_STEPS:.0f} ns/step "
              f"({N_STEPS} steps/tile)")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
