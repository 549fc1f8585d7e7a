"""The dispatching thread's wait for decoded frames, ms a frame: the
program's ``dispatch.wait_decode`` span summed over the window's frames.
Moves dir_mpix_s."""

from lens_bench.metrics._common import zone_ms_per_frame


def read(ctx):
    return zone_ms_per_frame(ctx, "dispatch.wait_decode")
