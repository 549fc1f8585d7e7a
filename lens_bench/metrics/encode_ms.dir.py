"""EXR encode, ms a frame: the program's ``encode`` tracing zone summed
over the window's frames (thread time: calls overlap on ``-j`` threads).
Moves dir_mpix_s."""

from lens_bench.metrics._common import zone_ms_per_frame


def read(ctx):
    return zone_ms_per_frame(ctx, "encode")
