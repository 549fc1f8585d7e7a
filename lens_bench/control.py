"""The control, and planted faults: a run with the program's remap replaced.

Every limit of ``compare.py`` has to reject the control: the reference put
in the program's place with its pixel arithmetic in bfloat16, the nearest
precision below the float32 the configurations state (coordinates stay
float32: bfloat16 coordinates would move taps by whole pixels, which any
check catches). The faults are what the cells can have: an output left
unwritten (zeros), an answer altered where it is produced, and, for the
directory run, half the frames not written.

On the card, at the cell's own size, a short window a seed:

    python3 -m lens_bench.control --workload headline.resident \
        --seeds 11 12 13 --seconds 2 [--fault control]

prints each run's numbers compared and whether ``correct`` came out false.
The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import torch

from . import cells, harness, program
from .reference import remap as ref

FAULTS = ("control", "zeros", "altered", "drop_half")


def replacement(fault: str, cfg: dict):
    """A function in place of ``remap_tonemap_batch``: the control, or a
    fault planted in the program's own remap."""
    real = program.remap_batch()

    def control(batch, rotation, **kw):
        return ref.remap(batch, cfg, dtype=torch.bfloat16)

    def zeros(batch, rotation, **kw):
        real(batch, rotation, **kw)
        return torch.zeros((batch.shape[0], kw["out_h"], kw["out_w"], batch.shape[3]),
                           dtype=torch.float32, device=batch.device)

    def altered(batch, rotation, **kw):
        out = real(batch, rotation, **kw)
        out[:, : min(8, out.shape[1]), : min(128, out.shape[2])] += 0.01
        return out

    return {"control": control, "zeros": zeros, "altered": altered}[fault]


@contextlib.contextmanager
def program_replaced(cell: cells.Cell, fault: str):
    """Runs what is inside with the cell's timed path broken by ``fault``."""
    kind = cell.traffic["kind"]
    if fault == "drop_half":
        if kind != "exr_dir":
            raise ValueError("drop_half applies to the directory run only")
        cli = program.module("cli")
        real_discover = cli.discover_files

        def half(*a, **kw):
            found = real_discover(*a, **kw)
            return found[: len(found) // 2] if len(found) > 1 else found

        cli.discover_files = half
        try:
            yield
        finally:
            cli.discover_files = real_discover
        return
    fn = replacement(fault, cell.config)
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
    ap = argparse.ArgumentParser(prog="python3 -m lens_bench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--fault", choices=FAULTS, default="control")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("lens_bench.control: needs a CUDA card", file=sys.stderr)
        return 2
    cell = cells.load_cell(args.workload)
    rejected = True
    for seed in args.seeds:
        ctx = harness.RunContext(seed=seed, seconds=args.seconds, trace=False, device="cuda",
                                 started=time.time())
        with program_replaced(cell, args.fault):
            line = harness.run_cell(cell, ctx)
        rejected &= not line["correct"]
        print(json.dumps({"workload": args.workload, "fault": args.fault, "seed": seed,
                          "correct": line["correct"], "attempted": line["attempted"],
                          "failed": line["failed"], "checks": line["checks"]}), flush=True)
    return 0 if rejected else 1


if __name__ == "__main__":
    sys.exit(main())
