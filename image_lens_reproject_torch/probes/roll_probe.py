"""Probe: every tile rolled along its last axis by its own dynamic shift.

Port of the JAX package's ``bench/roll_probe.py``. ``lane_roll`` (kernel
``csrc/roll_probe.cu``, replacing K7, ``build``) takes an ``(n, h, w)``
float32 tensor and an ``(n,)`` int32 shift per tile (the JAX probe's
``(1, n)`` table, flattened) and returns ``out[t, r, j] = x[t, r, (j +
sh[t]) mod w]``: a roll left by ``sh[t]``, ``np.roll(x[t], -sh[t], axis=1)``.
A CPU tensor runs the plain version; a CUDA tensor launches the kernel or
raises. ``LAUNCHES`` counts the kernel's launches.

``python -m image_lens_reproject_torch.probes.roll_probe [--device cpu]``
checks it against ``np.roll`` on 32 (80, 256) tiles (OK / FAIL), then on
the card times 2048 tiles made on the card: ns per tile.
"""

from __future__ import annotations

import sys
from typing import Optional, Sequence

import numpy as np
import torch

from . import NOT_MEASURED, event_ms, expect, launch, parse_args

LAUNCHES = 0
H, W = 80, 256  # the probe's tile
N_TILES, BIG_TILES = 32, 2048
_MAX_ROW_BLOCKS = 65535  # gridDim.y, at 8 rows a block


def _check(x: torch.Tensor, shifts: torch.Tensor) -> None:
    expect("lane_roll", x, "x", torch.float32, 3)
    expect("lane_roll", shifts, "shifts", torch.int32, 1, x.device)
    if shifts.shape[0] != x.shape[0] or -(-x.shape[1] // 8) > _MAX_ROW_BLOCKS:
        raise ValueError(f"lane_roll: {tuple(shifts.shape)} shifts for x {tuple(x.shape)}")


def roll_index(shifts: torch.Tensor, w: int) -> torch.Tensor:
    """(n, 1, w) int64: the column each output column reads, ``(j + sh) mod w``."""
    j = torch.arange(w, device=shifts.device)
    return torch.remainder(j[None, :] + shifts.long()[:, None], w)[:, None, :]


def lane_roll_plain(x: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of ``lane_roll``, on whatever device ``x`` lies."""
    return torch.gather(x, 2, roll_index(shifts, x.shape[2]).expand(x.shape))


def lane_roll(x: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """``(n, h, w)`` float32, ``(n,)`` int32 -> ``(n, h, w)``: tile t rolled left by ``shifts[t]``."""
    global LAUNCHES
    _check(x, shifts)
    if x.device.type == "cpu":
        return lane_roll_plain(x, shifts)
    n, h, w = (int(d) for d in x.shape)
    out = torch.empty_like(x)
    if x.numel():
        launch("ilr_lane_roll", x, x.data_ptr(), shifts.data_ptr(), n, h, w, out.data_ptr())
        LAUNCHES += 1
    return out


def check_inputs():
    """The probe's check inputs, drawn as ``bench/roll_probe.py`` draws them:
    (rng, x (32, 80, 256), shifts (32,)); the rng goes on to draw the timing
    shifts."""
    rng = np.random.default_rng(0)
    x = rng.random((N_TILES, H, W), np.float32)
    shifts = rng.integers(0, 128, (1, N_TILES)).astype(np.int32)[0]
    shifts[:3] = (0, 127, 1)
    return rng, x, shifts


def timing_inputs(rng, dev: torch.device):
    """The probe's 2048 timing tiles, made on ``dev``, and their shifts."""
    ii = torch.arange(BIG_TILES, dtype=torch.float32, device=dev)[:, None, None]
    jj = torch.arange(W, dtype=torch.float32, device=dev)[None, None, :]
    x = torch.sin(ii * 0.37 + jj * 0.11).expand(BIG_TILES, H, W).contiguous()
    shifts = torch.from_numpy(rng.integers(0, 128, (1, BIG_TILES)).astype(np.int32)[0]).to(dev)
    return x, shifts


def main(argv: Optional[Sequence[str]] = None) -> int:
    dev = parse_args(argv, "A roll of each tile by its own shift: a check, then a time on the card.")
    rng, x, shifts = check_inputs()
    out = lane_roll(torch.from_numpy(x).to(dev), torch.from_numpy(shifts).to(dev)).cpu().numpy()
    want = np.stack([np.roll(x[i], -int(shifts[i]), axis=1) for i in range(N_TILES)])
    err = float(np.abs(out - want).max())
    print(f"dynamic lane roll: max err {err:.2e} {'OK' if err == 0 else 'FAIL'}")

    if dev.type == "cpu":
        print(NOT_MEASURED)
    else:
        xb, sb = timing_inputs(rng, dev)
        ms = event_ms(lambda: lane_roll(xb, sb), warmup=3, reps=20)
        print(f"lane roll ({H},{W}): {ms * 1e6 / BIG_TILES:.0f} ns/tile")
    return 0 if err == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
