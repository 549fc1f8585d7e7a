"""The copy to the card, ms a frame: the program's ``dispatch.stack``
(``np.stack`` of the batch) and ``dispatch.h2d`` (the pageable copy) spans
summed over the window's frames. Moves dir_mpix_s."""

from lens_bench.metrics._common import zone_ms_per_frame


def read(ctx):
    parts = [zone_ms_per_frame(ctx, z) for z in ("dispatch.stack", "dispatch.h2d")]
    if all(p is None for p in parts):
        return None
    return sum(p for p in parts if p is not None)
