"""A frame's wait for an encode thread, ms a frame: the program's
``encode.queued`` span (from the frame's submission to the start of its
encode) summed over the window's frames. Moves dir_mpix_s."""

from lens_bench.metrics._common import zone_ms_per_frame


def read(ctx):
    return zone_ms_per_frame(ctx, "encode.queued")
