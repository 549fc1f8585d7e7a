"""What every driver shares: the run's context and result, the seeded
sample of outputs kept for the check, and one run of a cell end to end.

``run_cell`` drives a cell on a given device and builds the result line;
``run.py`` calls it after its look for the chips, and the tests call it on
the CPU. A driver's ``run(cell, ctx)`` makes the inputs from the seed,
warms up, drives the program for ``ctx.seconds``, reads the memory peak,
frees the program's state and checks the outputs against the reference.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time
import types
from typing import Dict, List

import numpy as np
import torch

from . import cells
from .compare import Checks

FORBIDDEN = ("jax", "jaxlib", "flax", "image_lens_reproject_tpu")


def process_start() -> float:
    """When this process started, on ``time.time()``'s clock (Linux's
    /proc, to its 10 ms tick; the time of this call elsewhere)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


@dataclasses.dataclass
class RunContext:
    seed: int
    seconds: float
    trace: bool
    device: str  # "cuda" on the chip, "cpu" in the tests
    started: float  # process start, time.time()'s clock

    @property
    def cuda(self) -> bool:
        return self.device == "cuda"

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()


@dataclasses.dataclass
class DriverResult:
    attempted: int
    failed: int
    e2e: Dict[str, float]
    checks: Checks
    memory_peak_bytes: int
    frames: int  # frames in the window
    summary: object = None  # trace.Summary of the traced slice, or None
    traced_frames: int = 0
    zones: Dict[str, tuple] = dataclasses.field(default_factory=dict)


class Reservoir:
    """A uniform sample of ``k`` of a stream's items, drawn from the seed
    (reservoir sampling), whatever the stream's length."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.items: List[tuple] = []
        self._rng = np.random.default_rng(int(seed) % 2**63)
        self.seen = 0

    def offer(self, item: tuple) -> None:
        i = self.seen
        self.seen += 1
        if i < self.k:
            self.items.append(item)
            return
        j = int(self._rng.random() * (i + 1))
        if j < self.k:
            self.items[j] = item


def warmed_up(ctx: RunContext) -> None:
    """Called once a driver has warmed up: in a traced run the profiler's
    own start-up is paid here, the card is left idle, and the memory peak
    counts from here (what the inputs hold stays counted)."""
    if ctx.trace:
        from .trace import warm_profiler

        warm_profiler(ctx.cuda)
    ctx.sync()
    if ctx.cuda:
        torch.cuda.reset_peak_memory_stats()


def peak_bytes(ctx: RunContext) -> int:
    return int(torch.cuda.max_memory_allocated()) if ctx.cuda else 0


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that no run may load."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def device_info(ctx: RunContext, chips: int, peak: int) -> dict:
    if ctx.cuda:
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
                "memory_peak_bytes": peak}
    return {"platform": "cpu", "kind": "cpu", "count": chips, "memory_peak_bytes": peak}


def run_cell(cell: cells.Cell, ctx: RunContext) -> dict:
    """One run of ``cell``: the result line as a dict, ``checks`` last."""
    res: DriverResult = cells.driver(cell.traffic["kind"]).run(cell, ctx)
    if ctx.trace:
        rctx = types.SimpleNamespace(cell=cell, result=res, summary=res.summary,
                                     device=torch.device(ctx.device))
        metrics = {}
        for m in cell.per_layer:
            value = cells.reader(m["name"], cell.root)(rctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        metrics = {}
        for m in cell.end_to_end:
            if m["name"] not in res.e2e:
                raise RuntimeError(f"driver {cell.traffic['kind']} gave no {m['name']}")
            metrics[m["name"]] = {"value": float(res.e2e[m["name"]]), "unit": m["unit"]}
    device = device_info(ctx, cell.chips, res.memory_peak_bytes)
    line = {"correct": bool(res.checks.correct and res.failed == 0),
            "attempted": res.attempted, "failed": res.failed, "metrics": metrics,
            "device": device}
    if ctx.trace and res.summary is not None:
        device["busy_s"] = res.summary.busy_s
        device["window_s"] = res.summary.window_s
        line["breakdown"] = res.summary.breakdown()
    line["checks"] = res.checks.table()
    return line


def setup_seconds(ctx: RunContext) -> float:
    """Process start to now: called at the first timed frame."""
    return time.time() - ctx.started

