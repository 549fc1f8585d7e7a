"""Probe: a windowed tap gather, each pixel's taps read from its sub-tile's window.

Port of the JAX package's ``bench/ww2_probe.py``. ``window_gather``
(kernel ``csrc/ww2_probe.cu``) takes, for ``n_sub`` sub-tiles of 8 x 128
pixels, a window ``win`` ``(n_sub, rows, cols)`` float32 holding
``channels`` interleaved channels, each pixel's window-relative tap origin
``y0``, ``x0`` ``(n_sub, 8, 128)`` int32 and its tap weights ``wx``, ``wy``
``(taps, n_sub, 8, 128)`` float32, and returns ``(channels, n_sub, 8, 128)``::

    out[c, s, r, p] = sum over n, m < taps of (wx[m, s, r, p] * wy[n, s, r, p])
                      * win[s, clamp(y0 + n, 0, rows - 1), clamp((x0 + m) * channels + c, 0, cols - 1)]

summed from 0, n outer and m inner; ``taps`` 2 (bilinear) or 4 (bicubic),
the probe's two samplers.

One kernel replaces both of the JAX probe's kernels, K8: ``run_case``'s
two-step gather and ``run_drift_case``'s drift-corrected one. The TPU needed
the two steps (a lane gather at each window row, then a sublane gather for
each output row) because its gathers index lanes per selecting row, and the
drift correction because a selecting row's x origin may differ from the
output row's by one. On the inputs the probe admits (``x0`` the same on a
sub-tile's 8 rows, or drifting by at most 1) both compute the formula above.
A thread of the card reads its own pixel's taps, so neither step exists
here, as the window machinery of ROADMAP's "Not ported (removal)" does not.

A CPU tensor runs the plain version; a CUDA tensor launches the kernel or
raises. ``LAUNCHES`` counts the kernel's launches.

``python -m image_lens_reproject_torch.probes.ww2_probe [--device cpu]``
runs the JAX probe's ten cases, each against numpy (``max_err < 1e-5``,
the sums' order differs), one JSON line a case, then ``RESULT``.
"""

from __future__ import annotations

import json
import sys
from typing import Optional, Sequence

import numpy as np
import torch

from . import expect, launch, parse_args

ROWS, LANES = 8, 128  # a sub-tile's pixels
TAPS = (2, 4)  # the tap counts a side the kernel is built for
MAX_SHARED_BYTES = 227 * 1024  # Hopper's largest dynamic shared memory per block
TOLERANCE = 1e-5
LAUNCHES = 0

# The JAX probe's cases, in its order: (name, n_sub, gchunks, taps, channels,
# ng, drift). The window is (8 * ng, 128 * gchunks).
CASES = (
    ("bicubic C3 g1 ns4", 4, 1, 4, 3, 1, False),
    ("bicubic C3 g2 ns4", 4, 2, 4, 3, 1, False),
    ("bilinear C3 g1 ns2", 2, 1, 2, 3, 1, False),
    ("bilinear C4 g2 ns2", 2, 2, 2, 4, 1, False),
    ("bilinear C3 g2 ng2", 2, 2, 2, 3, 2, False),
    ("bicubic C3 g1 ng2", 2, 1, 4, 3, 2, False),
    ("DRIFT bicubic C3 g1", 4, 1, 4, 3, 1, True),
    ("DRIFT bicubic C3 g2", 2, 2, 4, 3, 1, True),
    ("DRIFT bilinear C3 g1", 2, 1, 2, 3, 1, True),
    ("DRIFT bilinear C4 g2", 2, 2, 2, 4, 1, True),
)


def _check(win, y0, x0, wx, wy, channels: int) -> None:
    name = "window_gather"
    expect(name, win, "win", torch.float32, 3)
    for what, t, dtype, ndim in (("y0", y0, torch.int32, 3), ("x0", x0, torch.int32, 3),
                                 ("wx", wx, torch.float32, 4), ("wy", wy, torch.float32, 4)):
        expect(name, t, what, dtype, ndim, win.device)
    n_sub, rows, cols = (int(d) for d in win.shape)
    taps = int(wx.shape[0])
    pixels = (n_sub, ROWS, LANES)
    if (tuple(y0.shape) != pixels or tuple(x0.shape) != pixels
            or tuple(wx.shape) != (taps,) + pixels or tuple(wy.shape) != tuple(wx.shape)):
        raise ValueError(f"{name}: y0/x0 must be {pixels} and wx/wy (taps,) + {pixels}, got "
                         f"{tuple(y0.shape)}, {tuple(x0.shape)}, {tuple(wx.shape)}, "
                         f"{tuple(wy.shape)}")
    if taps not in TAPS or channels < 1 or rows < 1 or cols < 1:
        raise ValueError(f"{name}: taps {taps} not in {TAPS}, channels {channels}, "
                         f"or an empty window {(rows, cols)}")
    if 4 * rows * cols > MAX_SHARED_BYTES:
        raise ValueError(f"{name}: a {rows} x {cols} window exceeds {MAX_SHARED_BYTES} bytes "
                         f"of shared memory")


def window_gather_plain(win: torch.Tensor, y0: torch.Tensor, x0: torch.Tensor,
                        wx: torch.Tensor, wy: torch.Tensor, channels: int) -> torch.Tensor:
    """The plain PyTorch version of ``window_gather``, on whatever device ``win`` lies."""
    n_sub, rows, cols = win.shape
    flat = win.reshape(n_sub, rows * cols)
    yl, xl = y0.long(), x0.long()
    taps = wx.shape[0]
    row = [(yl + n).clamp(0, rows - 1) * cols for n in range(taps)]
    out = []
    for c in range(channels):
        col = [((xl + m) * channels + c).clamp(0, cols - 1) for m in range(taps)]
        acc = torch.zeros_like(wx[0])
        for n in range(taps):
            for m in range(taps):
                tap = flat.gather(1, (row[n] + col[m]).reshape(n_sub, -1)).view_as(acc)
                acc = acc + tap * (wx[m] * wy[n])
        out.append(acc)
    return torch.stack(out)


def window_gather(win: torch.Tensor, y0: torch.Tensor, x0: torch.Tensor, wx: torch.Tensor,
                  wy: torch.Tensor, channels: int) -> torch.Tensor:
    """``(channels, n_sub, 8, 128)``: each pixel's taps from its sub-tile's window, weighted."""
    global LAUNCHES
    _check(win, y0, x0, wx, wy, channels)
    if win.device.type == "cpu":
        return window_gather_plain(win, y0, x0, wx, wy, channels)
    n_sub, rows, cols = (int(d) for d in win.shape)
    out = torch.empty((channels, n_sub, ROWS, LANES), dtype=torch.float32, device=win.device)
    if n_sub:
        launch("ilr_window_gather", win, win.data_ptr(), y0.data_ptr(), x0.data_ptr(),
               wx.data_ptr(), wy.data_ptr(), n_sub, rows, cols, int(wx.shape[0]), channels,
               out.data_ptr())
        LAUNCHES += 1
    return out


def case_inputs(rng, n_sub: int, gchunks: int, taps: int, channels: int, ng: int = 1,
                drift: bool = False):
    """(win, y0, x0, wx, wy) as numpy arrays, drawn from ``rng`` as the JAX
    probe's ``run_case`` (``drift=False``) or ``run_drift_case`` draws them."""
    width = gchunks * LANES
    rows = ng * ROWS
    win = rng.uniform(0, 1, (n_sub, rows, width)).astype(np.float32)
    cols_w = width // channels
    y0 = rng.integers(0, rows - taps + 1, (n_sub, ROWS, LANES)).astype(np.int32)
    if drift:
        # x0 in {base, base + 1} per pixel: a drift of at most 1 down a column.
        base = rng.integers(1, cols_w - taps - 1, (n_sub, 1, LANES))
        x0 = (base + rng.integers(0, 2, (n_sub, ROWS, LANES))).astype(np.int32)
    else:
        # The same x0 on every row of a sub-tile.
        x0 = np.broadcast_to(rng.integers(0, cols_w - taps + 1, (n_sub, 1, LANES)),
                             (n_sub, ROWS, LANES)).astype(np.int32).copy()
    wx = rng.uniform(-0.4, 1.0, (taps, n_sub, ROWS, LANES)).astype(np.float32)
    wy = rng.uniform(-0.4, 1.0, (taps, n_sub, ROWS, LANES)).astype(np.float32)
    return win, y0, x0, wx, wy


def reference(win, y0, x0, wx, wy, channels: int) -> np.ndarray:
    """The JAX probe's numpy reference (no clamp: its taps lie inside the window)."""
    taps, n_sub = wx.shape[:2]
    want = np.zeros((channels, n_sub, ROWS, LANES), np.float32)
    for s in range(n_sub):
        for n in range(taps):
            for m in range(taps):
                w = wx[m, s] * wy[n, s]
                gy, gx = y0[s] + n, x0[s] + m
                for c in range(channels):
                    want[c, s] += w * win[s, gy, gx * channels + c]
    return want


def cases():
    """The probe's ten cases in order, from seed 7: (name, channels, inputs)."""
    rng = np.random.default_rng(7)
    for name, n_sub, gchunks, taps, channels, ng, drift in CASES:
        yield name, channels, case_inputs(rng, n_sub, gchunks, taps, channels, ng, drift)


def main(argv: Optional[Sequence[str]] = None) -> int:
    dev = parse_args(argv, "A windowed tap gather on the JAX probe's ten cases.")
    ok = True
    for name, channels, inputs in cases():
        got = window_gather(*(torch.from_numpy(a).to(dev) for a in inputs), channels)
        err = float(np.abs(got.cpu().numpy() - reference(*inputs, channels)).max())
        rec = {"name": name, "max_err": err, "ok": err < TOLERANCE}
        ok &= rec["ok"]
        print(json.dumps(rec), flush=True)
    print("RESULT:", "PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
