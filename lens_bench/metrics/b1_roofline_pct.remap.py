"""Kernel B1's share of its bound, in %: the least time the card could
take for one frame of the configuration (``lens_bench/roofline.py``:
distinct texels read and output written over device memory's rate, or
the tap sums over the float32 rate, whichever is longer) over B1's mean
device time a frame, from the profiler's kernel events named
``remap_frame<..., false>`` (B1's full-frame instances). Moves
remap_mpix_s."""

from lens_bench import roofline

KERNEL = r"remap_frame<[^()]*false>"


def read(ctx):
    s = ctx.summary
    if s is None:
        return None
    seconds, launches = s.ops(KERNEL, "kernel")
    if launches == 0 or seconds <= 0:
        return None
    frames_per_launch = int(ctx.cell.traffic.get("batch", 1))
    bound, _ = roofline.remap_bound_s(ctx.cell.config, ctx.device)
    return 100.0 * bound * frames_per_launch * launches / seconds
