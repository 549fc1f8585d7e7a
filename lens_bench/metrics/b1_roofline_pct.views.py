"""Kernel B1's view mode against its bound, in %: the least time the card
could take for one frame of all the configuration's views over B1's mean
device time a frame in view mode, from the profiler's kernel events named
``remap_views<...>`` (no single-view launch has that name) over the frames
of the traced slice.

The bound of a frame is ``lens_bench/roofline.py``'s, taken over every
view at once: the distinct source texels that the taps of all the views
read (their union: a texel two views share is read from device memory
once at the least) plus every view's output, over device memory's rate,
or the tap sums of every view over the float32 rate, whichever is longer.
Moves remap_mpix_s."""

import torch

from lens_bench import roofline
from lens_bench.reference import projections as P
from lens_bench.reference import remap as R

KERNEL = r"remap_views<"


def union_footprint(cfg: dict, device, rows_per_block: int = R.ROWS_PER_BLOCK):
    """(texels, pixels): the distinct source texels that the taps of every
    supersample of every view (``views_deg``) read, and the pixels of all
    the views."""
    in_h, in_w, out_h, out_w = cfg["src_h"], cfg["src_w"], cfg["out_h"], cfg["out_w"]
    wrap = P.wraps(cfg["in_lens"])
    offsets = R.supersample_offsets(cfg.get("n_samples", 1))
    cols = torch.arange(out_w, device=device)[None, :]

    def taps():
        for view in cfg["views_deg"]:
            view_cfg = dict(cfg, rotation_deg=list(view))
            rot = R.rotation_of(view_cfg)
            rot = None if rot is None else torch.as_tensor(rot, device=device)
            for r0 in range(0, out_h, rows_per_block):
                rows = torch.arange(r0, min(out_h, r0 + rows_per_block), device=device)[:, None]
                for off_x in offsets:
                    for off_y in offsets:
                        sx, sy = R.source_coords(view_cfg, rot, rows, cols, off_x, off_y)
                        for y in R.taps(sy, in_h, cfg["interp"], False):
                            for x in R.taps(sx, in_w, cfg["interp"], wrap):
                                yield y * in_w + x

    return roofline.distinct(in_h * in_w, taps()), len(cfg["views_deg"]) * out_h * out_w


def frame_bound_s(cfg: dict, device):
    """(seconds, what binds) of one frame of every view."""
    texels, pixels = union_footprint(cfg, device)
    return roofline.bound_s(*roofline.counts(texels, cfg["channels"], pixels, cfg["interp"],
                                             cfg.get("n_samples", 1)))


def read(ctx):
    s = ctx.summary
    if s is None or ctx.result.traced_frames <= 0:
        return None
    seconds, launches = s.ops(KERNEL, "kernel")
    if launches == 0 or seconds <= 0:
        return None
    bound, _ = frame_bound_s(ctx.cell.config, ctx.device)
    return 100.0 * bound * ctx.result.traced_frames / seconds
