"""The copy back from the card, ms a frame: the program's ``dispatch.d2h``
span (which waits for the remap, then copies into pageable memory)
summed over the window's frames. Moves dir_mpix_s."""

from lens_bench.metrics._common import zone_ms_per_frame


def read(ctx):
    return zone_ms_per_frame(ctx, "dispatch.d2h")
