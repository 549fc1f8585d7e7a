"""Device idle share of the host-frame cell's traced slice, in %; copies
count as busy. Moves frame_ms_mean."""

from lens_bench.metrics._common import idle_pct


def read(ctx):
    return idle_pct(ctx)
