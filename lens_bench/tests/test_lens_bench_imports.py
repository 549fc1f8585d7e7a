"""What the benchmark loads: never JAX or the JAX package, and for the
reference nothing of the program either. Top-level names (before the
first dot) are compared whole: the port's name begins with the JAX
package's."""

from __future__ import annotations

import json
import re
import subprocess
import sys

from .conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "image_lens_reproject_tpu"}

PROBE = r"""
import json, sys, time
before = set(sys.modules)
{body}
print(json.dumps(sorted({{m.split(".")[0] for m in set(sys.modules) - before}})))
"""

RUN_A_CELL = r"""
sys.path.insert(0, "lens_bench/tests")
from lens_bench import cells, harness, control, run
from conftest import tiny, run_tiny
for name in [w["name"] for w in cells.load_benchmark()["workloads"]]:
    assert run_tiny(tiny(cells.load_cell(name)), trace=True)["correct"]
import importlib, pkgutil, lens_bench.metrics, lens_bench.drivers
for m in pkgutil.iter_modules(lens_bench.drivers.__path__):
    importlib.import_module("lens_bench.drivers." + m.name)
for w in cells.load_benchmark()["per_layer"]:
    cells.reader(w["name"])
"""

REFERENCE = r"""
import lens_bench.reference.remap, lens_bench.reference.projections
import lens_bench.roofline, lens_bench.compare, lens_bench.frames, lens_bench.exr
"""


def _loaded(body: str):
    proc = subprocess.run([sys.executable, "-c", PROBE.format(body=body)], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return set(json.loads(proc.stdout.strip().splitlines()[-1]))


def test_a_whole_run_of_every_cell_loads_no_jax():
    loaded = _loaded(RUN_A_CELL)
    assert "image_lens_reproject_torch" in loaded and "torch" in loaded
    assert not loaded & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    loaded = _loaded(REFERENCE)
    assert not loaded & (FORBIDDEN | {"image_lens_reproject_torch"})


def test_no_source_reads_the_tpu_benchmarks():
    """No import of JAX or the JAX package, and no path of the TPU
    benchmarks (``bench/``, ``bench.py``, ``chip_smoke.py``)."""
    banned = re.compile(r"(^|\n)\s*(import|from)\s+(jax|jaxlib|flax|image_lens_reproject_tpu)\b"
                        r"|chip_smoke|(?<![\w])bench(/|\.py)")
    for path in (ROOT / "lens_bench").rglob("*.py"):
        if "tests" not in path.parts:
            found = banned.search(path.read_text())
            assert found is None, f"{path}: {found.group(0)!r}"
