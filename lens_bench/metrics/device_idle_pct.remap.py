"""Device idle share of a resident cell's traced slice, in %: the share
of the slice in which the card ran neither a kernel nor a copy (the
union of device activity in the profiler's trace). The slice profiles
the card alone, so no recording of host events lengthens the gaps it
measures. Moves remap_mpix_s."""

from lens_bench.metrics._common import idle_pct


def read(ctx):
    return idle_pct(ctx)
