"""Shared by the benchmark's CPU tests: cells cut to a few pixels.

Run with ``python -m pytest lens_bench/tests`` from the repository's root;
the tests marked ``gpu`` run on a CUDA card and skip without one.
"""

from __future__ import annotations

import copy
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from lens_bench import cells, harness  # noqa: E402

CELLS = [w["name"] for w in cells.load_benchmark()["workloads"]]
TINY_SIZES = {"headline": dict(src_h=24, src_w=48, out_h=20, out_w=36),
              "fisheye_pano": dict(src_h=32, src_w=32, out_h=16, out_w=32)}
TINY_MIX = dict(pool=3, sample=2, trace_skip=2, trace_frames=3, trace_labelled=2,
                frames=3, threads=2)


def tiny(cell: cells.Cell) -> cells.Cell:
    """``cell`` at a few pixels and frames: the same lenses, sampler,
    rotation and tonemap; a rectilinear output keeps its aspect."""
    c = copy.deepcopy(cell)
    c.config.update(TINY_SIZES.get(c.config["name"], {}))
    out = c.config["out_lens"]
    if out["type"] == "rectilinear":
        out["sensor_height"] = out["sensor_width"] * c.config["out_h"] / c.config["out_w"]
    for k, v in TINY_MIX.items():
        if k in c.traffic:
            c.traffic[k] = v
    return c


def run_tiny(cell: cells.Cell, *, seed: int = 2**31 + 11, trace: bool = False,
             seconds: float = 0.2) -> dict:
    ctx = harness.RunContext(seed=seed, seconds=seconds, trace=trace, device="cpu",
                             started=time.time())
    return harness.run_cell(cell, ctx)


@pytest.fixture
def cuda():
    """Skips the test unless a CUDA card is present."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
