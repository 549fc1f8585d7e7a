"""The host-frame cell's tail: the 95th percentile, over every frame of
the window, of the host time of one ``process_batch`` call, in ms. Moves
frame_ms_mean."""


def read(ctx):
    return ctx.result.e2e.get("frame_ms_p95")
