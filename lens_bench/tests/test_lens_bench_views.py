"""The view cell, ``cubemap8k.views``: found by its files, run on the CPU at a
few pixels (``lens_bench/conftest.py`` gives ``conftest.tiny`` its size),
failed by a wrong face or a wrong shape, its control rejected for its
precision, and its roofline's union bound counted by hand.
"""

from __future__ import annotations

import importlib.util
import json
import shutil
import types

import pytest
import torch

from lens_bench import cells, control, program, trace, views_control
from lens_bench.drivers import views as views_driver
from lens_bench.reference import projections as P
from lens_bench.reference import remap as R

from .conftest import ROOT, run_tiny, tiny

CELL = "cubemap8k.views"
READERS = {"b1_roofline_pct.views", "device_idle_pct.remap", "launch_host_us.remap"}


def _reader_module(name):
    """The reader file ``lens_bench/metrics/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        "views_test_" + name.replace(".", "_"), ROOT / "lens_bench" / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_the_view_cell_is_found_by_its_files_alone(tmp_path):
    shutil.copytree(ROOT / "lens_bench", tmp_path / "lens_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    for bench in (None, tmp_path / "BENCHMARK.json"):
        cell = cells.load_cell(CELL, bench)
        assert cell.config["name"] == "cubemap8k" and cell.traffic["kind"] == "views"
        assert cell.config["reduced"] == [] and len(cell.config["views_deg"]) == 6
        assert {m["name"] for m in cell.end_to_end} == {"remap_mpix_s", "setup_s"}
        assert {m["name"] for m in cell.per_layer} == READERS
        assert all(callable(cells.reader(m["name"], cell.root)) for m in cell.per_layer)
    assert cells.driver("views") is views_driver


@pytest.mark.parametrize("traced", [False, True])
def test_a_tiny_view_run_is_correct(traced):
    cell = tiny(cells.load_cell(CELL))
    assert cell.config["src_w"] == 64 and cell.traffic["pool"] == 3
    line = run_tiny(cell, trace=traced)
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert line["checks"]["max_abs"]["value"] == 0.0
    # six faces of each of the two sampled outputs
    assert line["checks"]["frames_checked"]["value"] == 12
    if traced:
        assert set(line["metrics"]) <= READERS  # the CPU has no device trace or B1 spans
    else:
        assert set(line["metrics"]) == {"remap_mpix_s", "setup_s"}
        assert all(v["value"] > 0 for v in line["metrics"].values())


@pytest.mark.parametrize("face", [0, 2, 5])
def test_a_wrong_face_is_not_correct(monkeypatch, face):
    """One face of every output off by 0.002 at one pixel: ``correct`` false."""
    cell = tiny(cells.load_cell(CELL))
    real = program.remap_batch()

    def wrong_face(batch, rotation, **kw):
        out = real(batch, rotation, **kw)
        out[:, face, 5, 7, 0] += 0.002
        return out

    monkeypatch.setattr(program, "remap_batch", lambda: wrong_face)
    line = run_tiny(cell)
    assert line["correct"] is False and line["failed"] > 0
    assert line["checks"]["max_abs"]["value"] > 1e-3


def test_the_stack_is_the_configuration_s_views():
    cfg = cells.load_cell(CELL).config
    stack = views_driver.rotation_stack(cfg)
    assert stack.shape == (6, 3, 3) and str(stack.dtype) == "float32"
    for v, view in enumerate(cfg["views_deg"]):
        assert (stack[v] == P.rotation_matrix_degrees(*view)).all()
        assert views_driver.view_configs(cfg)[v]["rotation_deg"] == view


def _direct_union(cfg):
    """The distinct texels the taps of every view read, as a Python set."""
    in_h, in_w = cfg["src_h"], cfg["src_w"]
    seen = set()
    for view in cfg["views_deg"]:
        view_cfg = dict(cfg, rotation_deg=view)
        rot = R.rotation_of(view_cfg)
        rot = None if rot is None else torch.as_tensor(rot)
        rows = torch.arange(cfg["out_h"])[:, None]
        cols = torch.arange(cfg["out_w"])[None, :]
        sx, sy = R.source_coords(view_cfg, rot, rows, cols)
        for y in R.taps(sy, in_h, cfg["interp"], False):
            for x in R.taps(sx, in_w, cfg["interp"], P.wraps(cfg["in_lens"])):
                seen.update((y * in_w + x).flatten().tolist())
    return seen


@pytest.mark.parametrize("interp", ["bilinear", "bicubic"])
def test_the_union_bound_equals_a_direct_count(interp):
    cfg = dict(cells.load_cell(CELL).config, src_h=40, src_w=80, out_h=16, out_w=16,
               interp=interp)
    roof = _reader_module("b1_roofline_pct.views")
    texels, pixels = roof.union_footprint(cfg, torch.device("cpu"), rows_per_block=5)
    union = _direct_union(cfg)
    assert texels == len(union) and pixels == 6 * 16 * 16
    singles = [len(_direct_union(dict(cfg, views_deg=[v]))) for v in cfg["views_deg"]]
    assert max(singles) < texels < sum(singles)  # faces share texels along their edges
    taps = {"bilinear": 4, "bicubic": 16}[interp]
    bytes_, instr = 4 * 3 * (texels + pixels), 2 * pixels * 3 * taps
    assert roof.frame_bound_s(cfg, torch.device("cpu")) == max(
        (bytes_ / 3.35e12, "bytes"), (instr / (67e12 / 2), "operations"))


def test_the_roofline_reads_the_view_launches_only():
    cfg = dict(cells.load_cell(CELL).config, src_h=40, src_w=80, out_h=16, out_w=16)
    roof = _reader_module("b1_roofline_pct.views")
    bound, _ = roof.frame_bound_s(cfg, torch.device("cpu"))
    launches = {
        "void (anonymous namespace)::remap_views<4, 0, 1, 3, 1>(float const*)": (0.5, 100),
        "void (anonymous namespace)::remap_frame<4, 0, 1, 3, 1, false>(float const*)": (9.0, 600),
    }

    def ctx(ops, frames=100):
        s = trace.Summary(window_s=1.0, busy_s=1.0, device_ops=ops, by_category={"kernel": ops},
                          idle={})
        return types.SimpleNamespace(summary=s, cell=types.SimpleNamespace(config=cfg),
                                     device=torch.device("cpu"),
                                     result=types.SimpleNamespace(traced_frames=frames))

    assert roof.read(ctx(launches)) == pytest.approx(100.0 * bound * 100 / 0.5)
    # a parent without view mode: only single-view launches, nothing to read
    single = {k: v for k, v in launches.items() if "remap_frame" in k}
    assert roof.read(ctx(single)) is None
    assert roof.read(ctx(launches, frames=0)) is None


def test_the_wrapper_reader_subtracts_the_rotation_span():
    tracing = program.tracing()
    reader = _reader_module("launch_host_us.remap")
    tracing.reset_zones()
    try:
        assert reader.read(None) is None
        for _ in range(4):
            tracing.record("b1.wrapper", 0, 90_000)
            tracing.record("b1.rotation", 0, 2_000)
            tracing.record("b1.views", 0, 5_000)
        assert reader.read(None) == pytest.approx(88.0)
    finally:
        tracing.reset_zones()


def test_the_benchmark_only_adds_to_what_it_had():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert [c["name"] for c in bench["configs"]][-1] == "cubemap8k"
    assert [w["name"] for w in bench["workloads"]][-1] == CELL
    assert [m["name"] for m in bench["per_layer"]][-1] == "b1_roofline_pct.views"
    metrics = {m["name"]: m for m in bench["end_to_end"] + bench["per_layer"]}
    for name in ("remap_mpix_s", "device_idle_pct.remap", "launch_host_us.remap"):
        assert metrics[name]["workloads"] == ["headline.resident", "fisheye_pano.resident", CELL]


def test_an_output_of_another_shape_fails_whole(monkeypatch):
    """One face alone where the views should be: every sampled output fails,
    counted in ``wrong_shape``, with no face compared."""
    cell = tiny(cells.load_cell(CELL))
    real = program.remap_batch()
    monkeypatch.setattr(program, "remap_batch",
                        lambda: lambda batch, rotation, **kw: real(batch, rotation[4], **kw))
    line = run_tiny(cell)
    assert line["correct"] is False and line["failed"] == line["checks"]["wrong_shape"]["value"]
    assert line["checks"]["wrong_shape"]["value"] > 0
    assert line["checks"]["frames_checked"]["value"] == 0


def test_the_shipped_control_fails_the_view_cell_for_its_shape():
    """``control.py``'s control is one frame, not a stack of views: the cell
    rejects it for its shape, whatever its precision
    (``views_control.py`` is the control of this cell)."""
    cell = tiny(cells.load_cell(CELL))
    with control.program_replaced(cell, "control"):
        line = run_tiny(cell)
    assert line["correct"] is False and line["checks"]["wrong_shape"]["value"] == 2


def test_the_view_control_is_rejected_for_its_precision():
    """The reference in bfloat16 under every view's rotation: the right
    shape, every face compared, and rejected by both of the cell's limits."""
    cell = tiny(cells.load_cell(CELL))
    with views_control.program_replaced(cell):
        line = run_tiny(cell)
    checks = line["checks"]
    assert line["correct"] is False and checks["wrong_shape"]["value"] == 0
    assert checks["frames_checked"]["value"] == 12
    for name in ("max_abs", "p999_abs"):
        assert checks[name]["value"] > cell.config["accuracy"][name]


@pytest.mark.gpu
def test_the_view_control_is_rejected_on_the_card(cuda):
    """The view control at the cell's own size, three seeds, a short window:
    rejected for its precision, not its shape."""
    import time

    from lens_bench import harness

    cell = cells.load_cell(CELL)
    for seed in (2**31 + 901, 2**31 + 902, 2**31 + 903):
        with views_control.program_replaced(cell):
            line = harness.run_cell(cell, harness.RunContext(
                seed=seed, seconds=1.0, trace=False, device="cuda", started=time.time()))
        checks = line["checks"]
        assert line["correct"] is False and checks["wrong_shape"]["value"] == 0
        assert checks["p999_abs"]["value"] > cell.config["accuracy"]["p999_abs"]
