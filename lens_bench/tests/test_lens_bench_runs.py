"""Whole runs of every cell on the CPU at a few pixels: the result line, the
check, and the faults and the control that must make ``correct`` false.

These skip the harness's look for a card (``run.py``) and drive the rest of
a run. The ``gpu`` test runs the control at each cell's own size on the
card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from lens_bench import cells, control

from .conftest import CELLS, ROOT, run_tiny, tiny

# The host-frame cell is out of BENCHMARK.json until its host times steady
# (PERF.md, open questions). Its driver, mix and readers stay, so that the
# entries below are all a later change needs to bring it back.
HOSTIO_E2E = [{"name": "frame_ms_mean", "unit": "ms"}, {"name": "setup_s", "unit": "s"}]
HOSTIO_PER_LAYER = [{"name": n, "unit": u} for n, u in (
    ("latency_ms_p95.frame", "ms"), ("copy_ms.frame", "ms"), ("device_idle_pct.frame", "%"))]

FAULTS = [(name, fault) for name in CELLS for fault in control.FAULTS
          if fault != "drop_half" or name.endswith(".exr_dir")]


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct_and_well_formed(name, trace):
    cell = tiny(cells.load_cell(name))
    line = run_tiny(cell, trace=trace)
    assert list(line)[-1] == "checks"
    assert set(line) - {"breakdown"} == {"correct", "attempted", "failed", "metrics", "device",
                                        "checks"}
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert line["checks"]["max_abs"]["value"] == 0.0
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    wanted = {m["name"]: m["unit"] for m in (cell.per_layer if trace else cell.end_to_end)}
    got = {k: v["unit"] for k, v in line["metrics"].items()}
    if trace:
        # on the CPU only the program's spans are there to read
        assert set(got) <= set(wanted)
        assert len(line["breakdown"]["idle_gaps"]) <= 10 and "busy_s" in line["device"]
    else:
        assert got == wanted and all(v["value"] > 0 for v in line["metrics"].values())
    json.loads(json.dumps(line, allow_nan=False))


@pytest.mark.parametrize("name,fault", FAULTS)
def test_a_broken_timed_path_is_not_correct(name, fault):
    cell = tiny(cells.load_cell(name))
    with control.program_replaced(cell, fault):
        line = run_tiny(cell)
    assert line["correct"] is False and line["failed"] > 0


def _hostio_cell() -> cells.Cell:
    config = json.loads((ROOT / "lens_bench/configs/headline.json").read_text())
    traffic = json.loads((ROOT / "lens_bench/traffic/hostio.json").read_text())
    return tiny(cells.Cell(name="headline.hostio", chips=1, config=config, traffic=traffic,
                           end_to_end=HOSTIO_E2E, per_layer=HOSTIO_PER_LAYER, root=ROOT))


@pytest.mark.parametrize("trace", [False, True])
def test_the_host_frame_driver_runs_sound(trace):
    line = run_tiny(_hostio_cell(), trace=trace)
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    if trace:
        # on the CPU the profiler has no copies to read; the host tail is there
        assert set(line["metrics"]) == {"latency_ms_p95.frame"}
    else:
        assert set(line["metrics"]) == {"frame_ms_mean", "setup_s"}
        assert all(v["value"] > 0 for v in line["metrics"].values())


@pytest.mark.parametrize("fault", [f for f in control.FAULTS if f != "drop_half"])
def test_the_host_frame_driver_fails_a_broken_path(fault):
    cell = _hostio_cell()
    with control.program_replaced(cell, fault):
        line = run_tiny(cell)
    assert line["correct"] is False and line["failed"] > 0


def test_the_directory_run_reads_the_program_s_spans():
    line = run_tiny(tiny(cells.load_cell("headline.exr_dir")), trace=True)
    assert set(line["metrics"]) == {"encode_ms.dir", "decode_ms.dir", "dispatch_ms.dir"}


def _run_module(args, cwd, env=None):
    return subprocess.run([sys.executable, "-m", "lens_bench.run", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, **(env or {})})


def test_no_result_without_a_card():
    proc = _run_module(["--workload", "headline.resident", "--seed", "1", "--seconds", "1"],
                       ROOT, {"CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_no_result_with_the_benchmark_alone(tmp_path):
    import shutil

    shutil.copytree(ROOT / "lens_bench", tmp_path / "lens_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    proc = _run_module(["--workload", "headline.resident", "--seed", "1", "--seconds", "1"],
                       tmp_path)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_rejected_on_the_card(cuda, name):
    """The control at the cell's own size, three seeds, a short window."""
    cell = cells.load_cell(name)
    for seed in (2**31 + 101, 2**31 + 102, 2**31 + 103):
        with control.program_replaced(cell, "control"):
            from .conftest import harness
            import time

            line = harness.run_cell(cell, harness.RunContext(
                seed=seed, seconds=1.0, trace=False, device="cuda", started=time.time()))
        assert line["correct"] is False
        assert line["checks"]["p999_abs"]["value"] > cell.config["accuracy"]["p999_abs"]
