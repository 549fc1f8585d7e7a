"""The control of a ``views`` cell: the reference in bfloat16, one a view.

``control.py``'s control puts ``reference/remap.py`` with bfloat16 pixel
arithmetic in the program's place, one frame under the configuration's
``rotation_deg``. A ``views`` cell's output holds a frame a view
(``views_deg``), so its driver fails that control for its shape alone. The
control here is the same reference under each view's rotation, stacked on
axis 1 as the program's view axis is, so that the cell's limits reject it
for its precision.

On the card, at the cell's own size, a short window a seed:

    python3 -m lens_bench.views_control --workload cubemap8k.views \
        --seeds 11 12 13 --seconds 2

prints each run's numbers compared and whether ``correct`` came out false
(exit code 0 when every run was rejected). The benchmark's own runs never
run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import torch

from . import cells, harness, program
from .drivers.views import view_configs
from .reference import remap as ref


def control(cfg: dict):
    """A function in place of ``remap_tonemap_batch``: every view of the
    reference with bfloat16 pixel arithmetic, ``(B, V, out_h, out_w, C)``."""

    def remap(batch, rotation, **kw):
        return torch.stack([ref.remap(batch, c, dtype=torch.bfloat16)
                            for c in view_configs(cfg)], dim=1)

    return remap


@contextlib.contextmanager
def program_replaced(cell: cells.Cell):
    """Runs what is inside with the cell's timed path replaced by the control."""
    fn = control(cell.config)
    fused = program.module("ops.remap_fused")
    real_fused, real_entry = fused.remap_tonemap_batch, program.remap_batch
    fused.remap_tonemap_batch = fn
    program.remap_batch = lambda: fn
    try:
        yield
    finally:
        fused.remap_tonemap_batch = real_fused
        program.remap_batch = real_entry


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m lens_bench.views_control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("lens_bench.views_control: needs a CUDA card", file=sys.stderr)
        return 2
    cell = cells.load_cell(args.workload)
    if cell.traffic["kind"] != "views":
        print(f"lens_bench.views_control: {args.workload} is not a views cell", file=sys.stderr)
        return 2
    rejected = True
    for seed in args.seeds:
        ctx = harness.RunContext(seed=seed, seconds=args.seconds, trace=False, device="cuda",
                                 started=time.time())
        with program_replaced(cell):
            line = harness.run_cell(cell, ctx)
        rejected &= not line["correct"]
        print(json.dumps({"workload": args.workload, "fault": "control", "seed": seed,
                          "correct": line["correct"], "attempted": line["attempted"],
                          "failed": line["failed"], "checks": line["checks"]}), flush=True)
    return 0 if rejected else 1


if __name__ == "__main__":
    sys.exit(main())
