"""Probe: every tile rolled along its last axis by its own dynamic shift.

Port of the JAX package's ``bench/roll_probe.py``. ``lane_roll`` (kernel
``csrc/roll_probe.cu``, replacing K7, ``build``) takes an ``(n, h, w)``
float32 tensor and an ``(n,)`` int32 shift per tile (the JAX probe's
``(1, n)`` table, flattened) and returns ``out[t, r, j] = x[t, r, (j +
sh[t]) mod w]``: a roll left by ``sh[t]``, ``np.roll(x[t], -sh[t], axis=1)``.
A CPU tensor runs the plain version; a CUDA tensor launches the kernel or
raises. ``vector_instance`` picks the kernel's instance on the host: an
element a float4 where ``w % 4 == 0`` and both tensors start on 16-byte
boundaries, else a float; the kernel gives a warp each unit of ``ROWS``
rows x 32 elements. ``build.COUNTS`` counts the kernel's launches
(``probes.lane_roll``).

``python -m image_lens_reproject_torch.probes.roll_probe [--device cpu]``
checks it against ``np.roll`` on 32 (80, 256) tiles (OK / FAIL), then on
the card times 2048 tiles made on the card: ns per tile.
"""

from __future__ import annotations

import sys
from typing import Optional, Sequence

import numpy as np
import torch

from . import NOT_MEASURED, expect, launch, loop_ms, parse_args

H, W = 80, 256  # the probe's tile
N_TILES, BIG_TILES = 32, 2048
# The kernel's unit (csrc/roll_probe.cu): ROWS rows x 32 elements, a warp each.
ROWS = 4
INT32_LIMIT = 2**31  # the kernel counts units and dimensions in 32 bits
WIDTH_LIMIT = 2**30  # and a source column, below 2 w, in 32 bits

# The edge shapes chip_smoke.py and the tests hold the kernel to: widths
# that are and are not multiples of 4 (float4 and float instances), rows
# that do and do not fill a unit, one tile and the probe's 2048.
EDGE_W = (1, 3, 250, 256, 257)
EDGE_H = (1, 7, 80, 81)
EDGE_N = (1, BIG_TILES)


def edge_shifts(w: int) -> list:
    """Shifts of every kind for width ``w``: negative, 0, ``w - 1``, ``w``
    and past ``w``, and the int32 extremes."""
    return [-3 * w - 1, -w, -1, 0, 1, w - 1, w, w + 1, 5 * w + 3, -(2**31), 2**31 - 1]


def edge_inputs(n: int, h: int, w: int, dev, seed: int = 0) -> tuple:
    """(x (n, h, w) uniform in [0, 1), shifts (n,)), made on ``dev`` from
    ``seed``: the shifts ``edge_shifts(w)`` in turn, then random ones of both
    signs."""
    kinds = np.array(edge_shifts(w), np.int64)
    rng = np.random.default_rng(seed)
    shifts = np.concatenate([kinds, rng.integers(-4 * w, 4 * w, max(0, n - kinds.size))])[:n]
    gen = torch.Generator(dev).manual_seed(seed)
    x = torch.rand((n, h, w), generator=gen, device=dev)
    return x, torch.from_numpy(shifts.astype(np.int32)).to(dev)


def edge_cases(dev):
    """Every edge shape's inputs on ``dev``: at n = 1 one call for each of
    ``edge_shifts(w)``, at n = 2048 one call holding them all."""
    for n in EDGE_N:
        for h in EDGE_H:
            for w in EDGE_W:
                x, shifts = edge_inputs(n, h, w, dev, seed=h * 1000 + w)
                if n > 1:
                    yield x, shifts
                    continue
                for sh in edge_shifts(w):
                    yield x, torch.full((1,), sh, dtype=torch.int32, device=dev)


def vector_instance(w: int, x_ptr: int, out_ptr: int) -> bool:
    """Whether the kernel's float4 instance takes the tensors: whole float4s a
    row, both starting on 16-byte boundaries."""
    return w % 4 == 0 and x_ptr % 16 == 0 and out_ptr % 16 == 0


def units(n: int, h: int, w: int, vec: bool) -> int:
    """The kernel's units: ROWS rows x 32 elements (float4s or floats) of a tile."""
    cols = w // 4 if vec else w
    return n * -(-h // ROWS) * -(-cols // 32)


def refusal(n: int, h: int, w: int) -> Optional[str]:
    """Why the kernel's 32-bit counts cannot index an ``(n, h, w)`` tensor,
    or None."""
    if max(n, h, w) >= INT32_LIMIT or units(n, h, w, False) >= INT32_LIMIT:
        return "has 2**31 units or more"
    if w > WIDTH_LIMIT:
        return "is wider than 2**30"
    return None


def _check(x: torch.Tensor, shifts: torch.Tensor) -> None:
    expect("lane_roll", x, "x", torch.float32, 3)
    expect("lane_roll", shifts, "shifts", torch.int32, 1, x.device)
    if shifts.shape[0] != x.shape[0]:
        raise ValueError(f"lane_roll: {tuple(shifts.shape)} shifts for x {tuple(x.shape)}")
    why = refusal(*x.shape)
    if why:
        raise ValueError(f"lane_roll: x {tuple(x.shape)} {why}")


def roll_index(shifts: torch.Tensor, w: int) -> torch.Tensor:
    """(n, 1, w) int64: the column each output column reads, ``(j + sh) mod w``."""
    j = torch.arange(w, device=shifts.device)
    return torch.remainder(j[None, :] + shifts.long()[:, None], w)[:, None, :]


def lane_roll_plain(x: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of ``lane_roll``, on whatever device ``x`` lies."""
    return torch.gather(x, 2, roll_index(shifts, x.shape[2]).expand(x.shape))


def lane_roll(x: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """``(n, h, w)`` float32, ``(n,)`` int32 -> ``(n, h, w)``: tile t rolled left by ``shifts[t]``."""
    _check(x, shifts)
    if x.device.type == "cpu":
        return lane_roll_plain(x, shifts)
    n, h, w = (int(d) for d in x.shape)
    out = torch.empty_like(x)
    if x.numel():
        vec = vector_instance(w, x.data_ptr(), out.data_ptr())
        launch("ilr_lane_roll", x, x.data_ptr(), shifts.data_ptr(), n, h, w, int(vec),
               out.data_ptr())
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
        ms = loop_ms(lambda: lane_roll(xb, sb), warmup=3, reps=10)
        print(f"lane roll ({H},{W}): {ms * 1e6 / BIG_TILES:.0f} ns/tile")
    return 0 if err == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
