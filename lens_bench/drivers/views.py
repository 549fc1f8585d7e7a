"""Traffic kind ``views``: every frame on the card cut into several views, one call a frame.

A caller whose frames live on the card (a 360° video transcoder that
decodes on the GPU and cuts each equirect frame into cube faces) calls the
exported ``remap_tonemap_batch`` on a CUDA tensor, ``batch`` frames a call,
with the configuration's views (``views_deg``: (pan, pitch, roll) a view)
as one numpy ``(V, 3, 3)`` rotation stack, in a closed loop over a pool of
``pool`` distinct source frames made on the card from the seed. The
window ends with ``torch.cuda.synchronize()``.

``remap_mpix_s``: output pixels of every view of every frame remapped in
the window over the window's seconds. Traced slices and the seeded sample
as ``resident``; each view of a sampled output is checked against the
reference under that view's rotation, and a sampled output of another
shape than ``(batch, V, out_h, out_w, C)`` fails whole (``wrong_shape``).

Mix parameters: ``pool``, ``batch``, ``sample``, ``trace_skip``,
``trace_frames``, ``trace_labelled``.
"""

from __future__ import annotations

import time

import numpy as np

from .. import frames, program, trace
from ..compare import Checks, limits_of
from ..harness import (DriverResult, Reservoir, RunContext, peak_bytes, setup_seconds,
                       warmed_up)
from ..reference import projections as P
from ..reference import remap as ref


def view_configs(cfg: dict):
    """The configuration of each view alone: ``cfg`` with that view's
    rotation, as the reference and the roofline read one."""
    return [dict(cfg, rotation_deg=list(view)) for view in cfg["views_deg"]]


def rotation_stack(cfg: dict) -> np.ndarray:
    """The views' rotations as one float32 ``(V, 3, 3)``."""
    return np.stack([P.rotation_matrix_degrees(*view) for view in cfg["views_deg"]])


def run(cell, ctx: RunContext) -> DriverResult:
    cfg, mix = cell.config, cell.traffic
    batch = int(mix.get("batch", 1))
    pool_n = int(mix["pool"])
    pool = frames.make(pool_n * batch, cfg["src_h"], cfg["src_w"], cfg["channels"],
                       ctx.seed, ctx.device)
    slots = [pool[i * batch:(i + 1) * batch] for i in range(pool_n)]
    views = rotation_stack(cfg)
    kw = program.remap_kwargs(cfg)
    remap = program.remap_batch()
    for s in slots[:2]:
        remap(s, views, **kw)
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
        out = remap(slots[i], views, **kw)
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
    shaped = (batch, len(views), cfg["out_h"], cfg["out_w"], cfg["channels"])
    wrong_shape = 0
    for got, i in sample.items:
        if tuple(got.shape) != shaped:  # no faces to check: the output fails whole
            wrong_shape += 1
            failed += batch
            continue
        ok = True
        for v, view_cfg in enumerate(view_configs(cfg)):
            want = ref.remap(slots[i], view_cfg)
            ok &= checks.frame(got[:, v], want)
            del want
        failed += 0 if ok else batch
    checks.number("wrong_shape", wrong_shape, 0)
    return DriverResult(
        attempted=n_frames, failed=failed,
        e2e={"remap_mpix_s": n_frames * len(views) * cfg["out_h"] * cfg["out_w"] / window / 1e6,
             "setup_s": setup_s},
        checks=checks, memory_peak_bytes=peak, frames=n_frames,
        summary=None if slices is None else slices.summary,
        traced_frames=n_traced * batch)
