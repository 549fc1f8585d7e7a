"""Device dispatch, ms a frame: the program's ``device_dispatch`` zone
(stack, copy to the card, remap, copy back) summed over the window's
frames. Moves dir_mpix_s."""

from lens_bench.metrics._common import zone_ms_per_frame


def read(ctx):
    return zone_ms_per_frame(ctx, "device_dispatch")
