"""Finding cells, configurations, mixes, drivers and metric readers by name,
and ``BENCHMARK.json`` against the benchmark's contract."""

from __future__ import annotations

import json
import re
import shutil

import pytest

from lens_bench import cells

from .conftest import CELLS, ROOT, run_tiny, tiny

BENCH = cells.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_is_found_by_name(name):
    cell = cells.load_cell(name)
    config, mix = name.split(".")
    assert cell.config["name"] == config and cell.traffic["kind"]
    assert callable(cells.driver(cell.traffic["kind"]).run)
    assert (ROOT / "lens_bench" / "traffic" / f"{mix}.json").exists()
    for m in cell.per_layer:
        assert callable(cells.reader(m["name"]))
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and cell.per_layer
    assert all(m["moves"] in names for m in cell.per_layer)


def test_benchmark_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["lens_bench"] and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024
    every = BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] + BENCH["per_layer"]
    for entry in every:
        assert NAME.match(entry["name"]), entry["name"]
        for key in ("why", "layer", "source"):
            if key in entry:
                assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key]
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({e["name"] for e in BENCH[group]}) == len(BENCH[group])
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("lens_bench/") and (ROOT / c["file"]).exists()
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert w["name"] == f"{w['config']}.{w['traffic']}"
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert BENCH["command"][:3] == ["python3", "-m", "lens_bench.run"]


def test_a_cell_is_added_by_files_alone(tmp_path):
    """A configuration file, a mix file of an existing kind and their
    ``BENCHMARK.json`` entries make a new cell, found and run by name,
    in a copy of the benchmark whose files are left as they were."""
    shutil.copytree(ROOT / "lens_bench", tmp_path / "lens_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    config = json.loads((ROOT / "lens_bench/configs/fisheye_pano.json").read_text())
    config.update(name="fisheye_small", src_h=24, src_w=24, out_h=12, out_w=24,
                  interp="bicubic", rotation_deg=[0.0, 0.0, 0.0])
    (tmp_path / "lens_bench/configs/fisheye_small.json").write_text(json.dumps(config))
    mix = json.loads((ROOT / "lens_bench/traffic/resident.json").read_text())
    mix.update(pool=2, sample=2, trace_skip=1, trace_frames=2)
    (tmp_path / "lens_bench/traffic/resident_pair.json").write_text(json.dumps(mix))
    bench["configs"].append({"name": "fisheye_small", "source": "a test",
                             "file": "lens_bench/configs/fisheye_small.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "fisheye_small.resident_pair", "config": "fisheye_small",
                               "traffic": "resident_pair", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "fisheye_pano.resident" in m.get("workloads", []):
            m["workloads"].append("fisheye_small.resident_pair")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = cells.load_cell("fisheye_small.resident_pair", tmp_path / "BENCHMARK.json")
    assert cell.config["src_h"] == 24 and cell.traffic["pool"] == 2
    assert {m["name"] for m in cell.end_to_end} == {"remap_mpix_s", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {"b1_roofline_pct.remap",
                                                   "device_idle_pct.remap"}
    line = run_tiny(cell)
    assert line["correct"] and set(line["metrics"]) == {"remap_mpix_s", "setup_s"}
    for name in CELLS:
        assert cells.load_cell(name, tmp_path / "BENCHMARK.json").config == \
            cells.load_cell(name).config


def test_names_outside_the_rules_are_refused():
    with pytest.raises(ValueError):
        cells.driver("../run")
    with pytest.raises(ValueError):
        cells.reader("a/b")
    with pytest.raises(KeyError):
        cells.load_cell("headline.nothing")


def test_tiny_cells_keep_their_lenses():
    for name in CELLS:
        cell, small = cells.load_cell(name), tiny(cells.load_cell(name))
        assert small.config["in_lens"] == cell.config["in_lens"]
        assert small.config["interp"] == cell.config["interp"]
