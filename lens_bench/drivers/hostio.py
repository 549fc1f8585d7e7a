"""Traffic kind ``hostio``: host frames in, host frames back, one in flight.

A live pipeline hands the program one host frame at a time and waits for
the host frame it gets back: ``pipeline.process_batch([frame], opts)`` on
the configuration's options, cycling over ``pool`` distinct float32 host
frames made from the seed. Each call is timed on the host clock from the
call to its return (the stack, the copy to the card, the remap, the copy
back). ``frame_ms_mean`` is the window's seconds over the frames it
completed, in ms; ``frame_ms_p95``, the 95th percentile of the calls'
times over every frame of the window, is read per layer
(``metrics/latency_ms_p95.frame.py``).

A traced run profiles the card alone over ``trace_frames`` calls after
the first ``trace_skip``, then the host's events too over
``trace_labelled`` calls, which label the idle gaps
(``trace.LoopSlices``). A seeded sample of ``sample`` returned arrays is
checked against the reference once the window closes.

Mix parameters: ``pool``, ``sample``, ``trace_skip``, ``trace_frames``,
``trace_labelled``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import frames, program, trace
from ..compare import Checks, limits_of
from ..harness import (DriverResult, Reservoir, RunContext, peak_bytes, setup_seconds,
                       warmed_up)
from ..reference import remap as ref


def run(cell, ctx: RunContext) -> DriverResult:
    cfg, mix = cell.config, cell.traffic
    pool_n = int(mix["pool"])
    host = frames.make(pool_n, cfg["src_h"], cfg["src_w"], cfg["channels"], ctx.seed,
                       ctx.device).cpu().numpy()
    pool = [np.ascontiguousarray(host[i]) for i in range(pool_n)]
    del host
    rotation = ref.rotation_of(cfg)
    opts = program.pipeline_options(cfg, rotation, ctx.device)
    process = program.process_batch()
    for f in pool[:2]:
        process([f], opts)
    warmed_up(ctx)

    sample = Reservoir(int(mix["sample"]), ctx.seed)
    n_traced = int(mix["trace_frames"])
    slices = trace.LoopSlices(ctx.cuda, int(mix["trace_skip"]), n_traced,
                              int(mix["trace_labelled"])) if ctx.trace else None
    latencies = []
    setup_s = setup_seconds(ctx)
    t0 = time.perf_counter()
    while True:
        if slices is not None:
            slices.at(len(latencies))
        i = len(latencies) % pool_n
        t = time.perf_counter()
        out = process([pool[i]], opts)
        latencies.append(time.perf_counter() - t)
        sample.offer((out[0], i))
        if time.perf_counter() - t0 >= ctx.seconds and (
                slices is None or len(latencies) >= slices.end):
            break
    window = time.perf_counter() - t0
    if slices is not None:
        slices.at(len(latencies))
    peak = peak_bytes(ctx)

    del out
    checks = Checks(limits_of(cfg))
    failed = 0
    for got, i in sample.items:
        src = torch.from_numpy(pool[i][None]).to(ctx.device)
        want = ref.remap(src, cfg)[0]
        failed += 0 if checks.frame(torch.from_numpy(got).to(ctx.device), want) else 1
        del src, want
    lat_ms = np.asarray(latencies) * 1e3
    return DriverResult(
        attempted=len(latencies), failed=failed,
        e2e={"frame_ms_mean": 1e3 * window / len(latencies),
             "frame_ms_p95": float(np.percentile(lat_ms, 95)), "setup_s": setup_s},
        checks=checks, memory_peak_bytes=peak, frames=len(latencies),
        summary=None if slices is None else slices.summary, traced_frames=n_traced)
