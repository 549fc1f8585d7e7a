"""Kernel B1's launch wrapper, host µs a call: the program's ``b1.wrapper``
span less its ``b1.rotation`` span (the rotation's upload, which waits
for the kernel queued before it), over the wrapper's calls. The program
records these spans only while a profiler runs, so they cover the traced
slices; read from its zone table (``utils/tracing.zone_totals``), since a
resident run's result carries no zones. Moves remap_mpix_s."""

from lens_bench import program


def read(ctx):
    zones = program.tracing().zone_totals()
    wrapper = zones.get("b1.wrapper")
    if wrapper is None or wrapper[1] <= 0:
        return None
    rotation = zones.get("b1.rotation", (0.0, 0))
    return 1e6 * (wrapper[0] - rotation[0]) / wrapper[1]
