"""The comparison that decides ``correct``.

Each number compared has its limit from the configuration's ``accuracy``
(the project's stated budget: max abs < 1e-3 against the reference on
EXR, BASELINE.json; p999 < 1e-4, the parity budget its tests hold). Per
checked frame:

- ``max_abs``: the largest |out - ref| over the values finite in both;
- ``p999_abs``: the 99.9th percentile of |out - ref| over those values;
- ``nan_mismatch``: values not finite on a side where the other side
  is not the same NaN or infinity (limit 0).

A run's number is the worst over its checked frames. ``Checks`` keeps
each number beside its limit; ``print_table`` prints them.
"""

from __future__ import annotations

import json
import math
import sys
from typing import Dict

import torch

P999 = 0.999


def frame_numbers(got: torch.Tensor, ref: torch.Tensor) -> Dict[str, float]:
    """max_abs, p999_abs and nan_mismatch of one output against its reference."""
    if tuple(got.shape) != tuple(ref.shape):
        return {"max_abs": math.inf, "p999_abs": math.inf, "nan_mismatch": float(ref.numel())}
    got = got.to(torch.float32).reshape(-1)
    ref = ref.to(torch.float32).reshape(-1)
    fin_g, fin_r = torch.isfinite(got), torch.isfinite(ref)
    both = fin_g & fin_r
    same_inf = (~fin_g) & (~fin_r) & (got == ref)
    same_nan = torch.isnan(got) & torch.isnan(ref)
    mismatch = int((~both & ~same_inf & ~same_nan).sum())
    diff = (got[both] - ref[both]).abs()
    if diff.numel() == 0:
        return {"max_abs": 0.0, "p999_abs": 0.0, "nan_mismatch": float(mismatch)}
    k = min(diff.numel(), max(1, math.ceil(P999 * diff.numel())))
    p999 = float(torch.kthvalue(diff, k).values)
    return {"max_abs": float(diff.max()), "p999_abs": p999, "nan_mismatch": float(mismatch)}


class Checks:
    """Numbers compared, each with its limit; a number passes at or below it."""

    def __init__(self, limits: Dict[str, float]):
        self.limits = dict(limits)
        self.values: Dict[str, float] = {}
        self.frames_checked = 0
        self.frames_failed = 0

    def frame(self, got: torch.Tensor, ref: torch.Tensor) -> bool:
        """Adds one checked frame; returns whether it passed."""
        nums = frame_numbers(got, ref)
        ok = all(nums[k] <= self.limits[k] for k in nums)
        for k, v in nums.items():
            self.values[k] = max(self.values.get(k, 0.0), v)
        self.frames_checked += 1
        self.frames_failed += 0 if ok else 1
        return ok

    def number(self, name: str, value: float, limit: float) -> None:
        """Adds a number of the run's own (a count of missing frames, say)."""
        self.limits[name] = limit
        self.values[name] = max(self.values.get(name, 0.0), float(value))

    @property
    def correct(self) -> bool:
        return self.frames_checked > 0 and all(
            self.values.get(k, math.inf) <= lim for k, lim in self.limits.items())

    def table(self) -> Dict[str, Dict[str, float]]:
        out = {k: {"value": min(self.values.get(k, math.inf), sys.float_info.max),
                   "limit": lim} for k, lim in self.limits.items()}
        out["frames_checked"] = {"value": self.frames_checked, "limit": 1}
        return out

def print_table(table: Dict[str, Dict[str, float]], stream=None) -> None:
    """One line a number compared: its value and its limit."""
    stream = stream or sys.stderr
    for k, v in table.items():
        op = ">=" if k == "frames_checked" else "<="
        print(f"check {k}: {json.dumps(v['value'])} (limit {op} {json.dumps(v['limit'])})",
              file=stream, flush=True)


def limits_of(cfg: dict) -> Dict[str, float]:
    acc = cfg["accuracy"]
    return {"max_abs": float(acc["max_abs"]), "p999_abs": float(acc["p999_abs"]),
            "nan_mismatch": 0.0}
