"""Shared by the per-layer readers: a reader returns None when its run
has nothing for it to read."""

from __future__ import annotations


def idle_pct(ctx):
    """The share of the traced slice in which the card ran no kernel,
    copy or fill, in % (``trace.LoopSlices``'s slice of the card alone in
    a loop of calls)."""
    s = ctx.summary
    if s is None or s.window_s <= 0 or s.busy_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)


def zone_ms_per_frame(ctx, zone):
    """A program tracing zone's total over the window, in ms a frame."""
    total = ctx.result.zones.get(zone)
    if total is None or ctx.result.frames <= 0:
        return None
    return 1e3 * total[0] / ctx.result.frames
