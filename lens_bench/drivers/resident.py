"""Traffic kind ``resident``: frames already on the card, remapped back to back.

A caller whose frames live on the card (a GPU pipeline) calls the exported
``remap_tonemap_batch`` on a CUDA tensor, ``batch`` frames a call, in a
closed loop, cycling over a pool of ``pool`` distinct source frames made
on the card from the seed; the rotation goes in as the numpy (3, 3) the
pipeline passes. The window ends with ``torch.cuda.synchronize()``.

``remap_mpix_s``: output pixels of every frame remapped in the window over
the window's seconds. A traced run profiles ``trace_frames`` calls after
the first ``trace_skip`` of the window. A seeded sample of ``sample``
outputs is kept and checked against the reference once the window closes.

Mix parameters: ``pool``, ``batch``, ``sample``, ``trace_skip``,
``trace_frames``.
"""

from __future__ import annotations

import time

from .. import frames, program, trace
from ..compare import Checks, limits_of
from ..harness import (DriverResult, Reservoir, RunContext, peak_bytes, setup_seconds,
                       warmed_up)
from ..reference import remap as ref


def run(cell, ctx: RunContext) -> DriverResult:
    cfg, mix = cell.config, cell.traffic
    batch = int(mix.get("batch", 1))
    pool_n = int(mix["pool"])
    pool = frames.make(pool_n * batch, cfg["src_h"], cfg["src_w"], cfg["channels"],
                       ctx.seed, ctx.device)
    slots = [pool[i * batch:(i + 1) * batch] for i in range(pool_n)]
    rotation = ref.rotation_of(cfg)
    kw = program.remap_kwargs(cfg)
    remap = program.remap_batch()
    for s in slots[:2]:
        remap(s, rotation, **kw)
    warmed_up(ctx)

    sample = Reservoir(int(mix["sample"]), ctx.seed)
    n_traced = int(mix["trace_frames"])
    slices = trace.LoopSlices(ctx.cuda, int(mix["trace_skip"]), n_traced,
                              int(mix["trace_labelled"])) if ctx.trace else None
    calls = 0
    setup_s = setup_seconds(ctx)
    t0 = time.perf_counter()
    while True:
        if slices is not None:
            slices.at(calls)
        i = calls % pool_n
        out = remap(slots[i], rotation, **kw)
        sample.offer((out, i))
        calls += 1
        if time.perf_counter() - t0 >= ctx.seconds and (
                slices is None or calls >= slices.end):
            break
    if slices is not None:
        slices.at(calls)
    ctx.sync()
    window = time.perf_counter() - t0
    peak = peak_bytes(ctx)

    n_frames = calls * batch
    del out
    checks = Checks(limits_of(cfg))
    failed = 0
    for got, i in sample.items:
        want = ref.remap(slots[i], cfg)
        failed += 0 if checks.frame(got, want) else batch
        del want
    return DriverResult(
        attempted=n_frames, failed=failed,
        e2e={"remap_mpix_s": n_frames * cfg["out_h"] * cfg["out_w"] / window / 1e6,
             "setup_s": setup_s},
        checks=checks, memory_peak_bytes=peak, frames=n_frames,
        summary=None if slices is None else slices.summary,
        traced_frames=n_traced * batch)
