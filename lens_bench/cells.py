"""Finding a cell, its configuration, its traffic mix, its driver and its
metric readers by name.

``BENCHMARK.json`` names the cells (``workloads``), the configurations and
their files, and the metrics. A traffic mix ``<mix>`` is
``lens_bench/traffic/<mix>.json``; its ``kind`` names the traffic driver
``lens_bench/drivers/<kind>.py``; a per-layer metric ``<metric>`` is read by
``lens_bench/metrics/<metric>.py``, whose ``read(ctx)`` returns a number
or None. Files are found beside the ``BENCHMARK.json`` they are named in,
so a copy of the benchmark finds its own.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import re
from pathlib import Path
from typing import Callable, List, Optional

HERE = Path(__file__).resolve().parent
BENCHMARK = HERE.parent / "BENCHMARK.json"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    root: Path  # the directory of the BENCHMARK.json it came from


def load_benchmark(path: Path = BENCHMARK) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, benchmark: Optional[Path] = None) -> Cell:
    """The cell ``name`` of ``benchmark`` (the repository's by default)."""
    path = Path(benchmark or BENCHMARK)
    bench = load_benchmark(path)
    root = path.parent
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in {path}; there are {sorted(work)}")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(root / conf["file"]) as f:
        config = json.load(f)
    if not NAME.match(w["traffic"]):
        raise ValueError(f"bad traffic name {w['traffic']!r}")
    with open(root / "lens_bench" / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return Cell(name=name, chips=int(w["chips"]), config=config, traffic=traffic,
                end_to_end=e2e, per_layer=per_layer, root=root)


def driver(kind: str):
    """The driver module of a traffic kind."""
    if not re.match(r"^[a-z][a-z0-9_]*$", kind):
        raise ValueError(f"bad traffic kind {kind!r}")
    return importlib.import_module(f"lens_bench.drivers.{kind}")


def reader(metric: str, root: Path = HERE.parent) -> Callable:
    """``read(ctx)`` of ``<root>/lens_bench/metrics/<metric>.py``."""
    if not NAME.match(metric):
        raise ValueError(f"bad metric name {metric!r}")
    path = root / "lens_bench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "lens_bench.metrics." + metric.replace(".", "__"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
