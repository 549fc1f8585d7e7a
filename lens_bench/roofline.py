"""What a remap of these inputs must cost the card at the least.

Frozen from the port's smoke script's bound arithmetic, counting from the
reference's own coordinates (``reference/remap.py``) so that nothing of
the program is asked. The bound of a launch is the larger of

- bytes over device memory's rate: the distinct source texels the taps of
  every supersample read, once each, and the output written once, each
  4 * C bytes;
- float32 instructions over the rate the SMs issue them: the tap sums
  alone (a multiply and an add a tap, channel and supersample), counted
  low. The data sheet's 67 TFLOP/s counts a fused multiply-add as two
  operations; the port builds with ``-fmad=false``, so every multiply and
  add is an instruction of its own, at half that rate.

Rates: NVIDIA H100 SXM data sheet, at its 700 W limit.
"""

from __future__ import annotations

import torch

from .reference import projections as P
from .reference import remap as R

HBM_BYTES_PER_S = 3.35e12
FP32_INSTR_PER_S = 67e12 / 2
TAPS = {"nearest": 1, "bilinear": 2, "bicubic": 4}


def bound_s(n_bytes: float, n_instr: float):
    """(seconds, what binds) for moving ``n_bytes`` of device memory and
    issuing ``n_instr`` float32 instructions."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_instr / FP32_INSTR_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def distinct(size: int, index_tensors) -> int:
    """How many values of ``range(size)`` the integer tensors hold."""
    seen = None
    for t in index_tensors:
        if seen is None:
            seen = torch.zeros(size, dtype=torch.bool, device=t.device)
        seen[t.reshape(-1)] = True
    return 0 if seen is None else int(seen.sum())


def footprint(cfg: dict, device, rows_per_block: int = R.ROWS_PER_BLOCK):
    """(texels, pixels): the distinct source texels that the taps of every
    supersample of the configuration's output frame read, and its pixels."""
    in_h, in_w, out_h, out_w = cfg["src_h"], cfg["src_w"], cfg["out_h"], cfg["out_w"]
    rot = R.rotation_of(cfg)
    rot = None if rot is None else torch.as_tensor(rot, device=device)
    wrap = P.wraps(cfg["in_lens"])
    offsets = R.supersample_offsets(cfg.get("n_samples", 1))
    cols = torch.arange(out_w, device=device)[None, :]

    def taps():
        for r0 in range(0, out_h, rows_per_block):
            rows = torch.arange(r0, min(out_h, r0 + rows_per_block), device=device)[:, None]
            for off_x in offsets:
                for off_y in offsets:
                    sx, sy = R.source_coords(cfg, rot, rows, cols, off_x, off_y)
                    for y in R.taps(sy, in_h, cfg["interp"], False):
                        for x in R.taps(sx, in_w, cfg["interp"], wrap):
                            yield y * in_w + x

    return distinct(in_h * in_w, taps()), out_h * out_w


def counts(texels: int, channels: int, pixels: int, interp: str, n_samples: int = 1):
    """(bytes, instructions) of a remap writing ``pixels`` pixels of
    ``channels`` from ``texels`` distinct source texels."""
    n_bytes = 4 * channels * (texels + pixels)
    n_instr = 2 * pixels * channels * TAPS[interp] ** 2 * n_samples ** 2
    return n_bytes, n_instr


def remap_bound_s(cfg: dict, device):
    """(seconds, what binds) of one frame of the configuration."""
    texels, pixels = footprint(cfg, device)
    return bound_s(*counts(texels, cfg["channels"], pixels, cfg["interp"],
                           cfg.get("n_samples", 1)))
