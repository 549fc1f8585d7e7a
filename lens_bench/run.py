"""One run of one benchmark cell on the card.

    python3 -m lens_bench.run --workload <config>.<mix> --seed <n> \
        --seconds <s> --trace <0|1>

from the root of a checkout that holds the port. Makes the cell's inputs
from the seed, warms up, drives the program for ``--seconds``, checks its
outputs against the plain reference and prints one JSON line last on
standard output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device`` and, traced, ``breakdown``; ``checks`` (each number compared
and its limit) comes last, and the same numbers are the last lines on
standard error. Exits non-zero, printing no result, without enough CUDA
cards or when a JAX module was loaded.
"""

from __future__ import annotations

import argparse
import json
import sys

from .compare import print_table
from .harness import process_start

STARTED = process_start()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m lens_bench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from . import cells, harness

    cell = cells.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("lens_bench: torch.cuda.is_available() is False; this benchmark runs on a CUDA "
              "card only", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"lens_bench: {args.workload} needs {cell.chips} cards, "
              f"torch.cuda.device_count() is {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    ctx = harness.RunContext(seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                             device="cuda", started=STARTED)
    line = harness.run_cell(cell, ctx)
    found = harness.forbidden_modules()
    if found:
        print(f"lens_bench: the run loaded {', '.join(found)}; no run may", file=sys.stderr)
        return 3
    print_table(line["checks"])
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
