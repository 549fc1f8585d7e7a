"""Host-device copies, ms a frame: the device time of the copies to and
from the card (the profiler's memcpy events) in the traced slice, over
its frames. Moves frame_ms_mean."""


def read(ctx):
    s = ctx.summary
    if s is None or ctx.result.traced_frames <= 0:
        return None
    seconds, count = s.ops(r"HtoD|DtoH", "gpu_memcpy")
    if count == 0:
        return None
    return 1e3 * seconds / ctx.result.traced_frames
