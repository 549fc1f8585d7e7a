"""The port's CLI and directory pipeline against the JAX package's CLI.

The JAX CLI runs with ``ILR_PLATFORM=cpu``, where the pipeline takes its
XLA path; the port runs with ``--device cpu``, where it takes its plain
PyTorch path. Both write HALF EXR, so the decoded outputs must agree within
one half-precision ulp: a float32 difference of a few ulps may round the
other way, and nothing more.
"""

import json
import re

import numpy as np
import pytest
import torch

from image_lens_reproject_tpu import cli as jax_cli
import chip_smoke
from image_lens_reproject_torch import cli
from image_lens_reproject_torch.io import exr
from image_lens_reproject_torch.ops import dispatch
from image_lens_reproject_torch.utils import tracing

F = np.float32
HEADLINE = [
    "--no-configs", "64,32", "--i-equirectangular", "full",
    "--rectilinear", "35,36", "--output-resolution", "48,27",
    "--rotation", "20,5,0", "--exposure", "1", "--reinhard", "4", "--bc",
]
FRAMES = ("f0.exr", "f1.exr", "f2.exr")


def _frames(directory, names=FRAMES, c=3):
    directory.mkdir()
    rng = np.random.default_rng(0)
    for name in names:
        exr.write_exr(str(directory / name), rng.uniform(0, 2, (32, 64, c)).astype(F))
    return directory


def _within_one_half_ulp(got, want):
    ulp = np.maximum(
        np.spacing(np.abs(want).astype(np.float16)), np.spacing(np.abs(got).astype(np.float16))
    ).astype(F)
    assert got.shape == want.shape
    assert (np.abs(got - want) <= ulp).all()


def _outputs(directory):
    return {p.name: exr.read_exr(str(p)).data for p in sorted(directory.glob("*.exr"))}


@pytest.fixture(autouse=True)
def _reset_pure_torch():
    yield
    dispatch.set_pure_torch(False)
    dispatch.set_rescue_override(None)
    dispatch.set_split_override(None)


@pytest.mark.parametrize("batch_size,ordering", [("1", "overlap"), ("2", "serial")])
def test_cli_matches_jax_cli(tmp_path, monkeypatch, batch_size, ordering):
    src = _frames(tmp_path / "in")
    monkeypatch.setenv("ILR_PLATFORM", "cpu")
    common = HEADLINE + ["-i", str(src), "--exr", "--batch-size", batch_size, "--ordering", ordering]
    assert jax_cli.main(common + ["-o", str(tmp_path / "jax")]) == 0
    assert cli.main(common + ["-o", str(tmp_path / "torch"), "--device", "cpu", "-j", "2"]) == 0
    want, got = _outputs(tmp_path / "jax"), _outputs(tmp_path / "torch")
    assert sorted(got) == sorted(want) == sorted(FRAMES)
    for name in FRAMES:
        assert got[name].shape == (27, 48, 3)
        _within_one_half_ulp(got[name], want[name])


def test_no_reproject_tonemap_matches_jax_cli(tmp_path, monkeypatch):
    src = _frames(tmp_path / "in", names=("a.exr",), c=4)
    monkeypatch.setenv("ILR_PLATFORM", "cpu")
    common = ["--no-configs", "64,32", "--i-equirectangular", "full", "--no-reproject",
              "--exposure", "0.5", "--reinhard", "3", "-i", str(src), "--exr"]
    assert jax_cli.main(common + ["-o", str(tmp_path / "jax")]) == 0
    assert cli.main(common + ["-o", str(tmp_path / "torch"), "--device", "cpu"]) == 0
    _within_one_half_ulp(_outputs(tmp_path / "torch")["a.exr"], _outputs(tmp_path / "jax")["a.exr"])


def test_pure_torch_gives_the_same_files(tmp_path):
    src = _frames(tmp_path / "in", names=("a.exr",))
    common = HEADLINE + ["-i", str(src), "--exr", "--device", "cpu"]
    assert cli.main(common + ["-o", str(tmp_path / "default")]) == 0
    assert cli.main(common + ["-o", str(tmp_path / "pure"), "--pure-torch"]) == 0
    assert dispatch.pure_torch_forced()
    assert (tmp_path / "pure" / "a.exr").read_bytes() == (tmp_path / "default" / "a.exr").read_bytes()


def test_skip_if_exists(tmp_path, capsys):
    src = _frames(tmp_path / "in", names=("a.exr", "b.exr"))
    out = tmp_path / "out"
    common = HEADLINE + ["-i", str(src), "-o", str(out), "--exr", "--device", "cpu", "--skip-if-exists"]
    assert cli.main(common) == 0
    (out / "a.exr").write_bytes(b"kept")
    (out / "b.exr").unlink()
    capsys.readouterr()
    assert cli.main(common) == 0
    text = capsys.readouterr().out
    # The message names the PNG path whatever the format, as the JAX CLI's does.
    assert f"Skipping '{out / 'a.png'}'. Already exists." in text
    assert "Skipping" not in text.replace(f"Skipping '{out / 'a.png'}'", "")
    assert (out / "a.exr").read_bytes() == b"kept"
    assert exr.read_exr(str(out / "b.exr")).data.shape == (27, 48, 3)


def test_corrupt_file_is_isolated(tmp_path, capsys):
    src = _frames(tmp_path / "in", names=("a.exr", "c.exr"))
    (src / "b.exr").write_bytes(b"not an exr file")
    out = tmp_path / "out"
    assert cli.main(HEADLINE + ["-i", str(src), "-o", str(out), "--exr", "--device", "cpu"]) == 0
    assert sorted(p.name for p in out.iterdir()) == ["a.exr", "c.exr"]
    captured = capsys.readouterr()
    assert "Error:" in captured.out
    assert "Failed 1 file(s): b.exr" in captured.err


def test_default_device_cuda_raises_without_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device, so --device cuda is valid")
    src = _frames(tmp_path / "in", names=("a.exr",))
    out = tmp_path / "out"
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(HEADLINE + ["-i", str(src), "-o", str(out), "--exr"])
    assert not any(out.iterdir())


def test_trace_dir_writes_profiler_trace(tmp_path):
    src = _frames(tmp_path / "in", names=("a.exr",))
    trace = tmp_path / "trace"
    common = HEADLINE + ["-i", str(src), "-o", str(tmp_path / "out"), "--exr", "--device", "cpu"]
    assert cli.main(common + ["--trace-dir", str(trace)]) == 0
    events = json.loads((trace / "trace.json").read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    # The dispatch zone and the remap's ops, and the decode and encode of
    # the pool threads, each on its own thread.
    assert {"device_dispatch", "aten::atan2", "decode", "encode"} <= names
    tids = {e["name"]: e["tid"] for e in events if e.get("name") in ("decode", "encode",
                                                                       "device_dispatch")}
    assert tids["decode"] != tids["device_dispatch"] != tids["encode"]


def test_dry_run_needs_no_device(tmp_path, capsys):
    assert cli.main(HEADLINE + ["-i", str(tmp_path), "-o", str(tmp_path / "o"), "--exr", "--dry-run"]) == 0
    assert "Dry-run" in capsys.readouterr().out


def test_usage_errors(capsys):
    assert cli.main(["-o", "/nonexistent", "--exr"]) == 1
    assert "No input specified" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        cli.main(["--pure-xla"])


# Output widths a multiple of 32 and few pixels: on the CPU the plain
# path's frame and its sub-tile lists then run every element through
# PyTorch's vector math (tests/test_torch_plan.py says why that matters).
PLANNED = {
    "equirect-rect-bicubic": HEADLINE[:7] + ["64,24"] + HEADLINE[8:],
    "equisolid-equirect-bilinear": [
        "--no-configs", "64,32", "--i-equisolid", "15,36,3.14159265358979",
        "--equirectangular", "full", "--output-resolution", "256,128",
        "--rotation", "30,10,5", "--bl",
    ],
}


@pytest.mark.parametrize("case", sorted(PLANNED))
def test_rescue_and_split_write_the_same_files(tmp_path, case):
    src = _frames(tmp_path / "in", names=("a.exr", "b.exr"))
    common = PLANNED[case] + ["-i", str(src), "--exr", "--device", "cpu"]
    assert cli.main(common + ["-o", str(tmp_path / "default")]) == 0
    assert not dispatch.rescue_enabled() and not dispatch.split_enabled()
    assert cli.main(common + ["-o", str(tmp_path / "planned"), "--rescue", "on", "--split", "on"]) == 0
    assert dispatch.rescue_enabled() and dispatch.split_enabled()
    # As in JAX, --split alone changes nothing: it needs --rescue.
    assert cli.main(common + ["-o", str(tmp_path / "split"), "--split", "on"]) == 0
    assert dispatch.split_enabled() and not dispatch.rescue_enabled()
    assert cli.main(common + ["-o", str(tmp_path / "rescue"), "--rescue", "on", "--split", "off"]) == 0
    for name in ("a.exr", "b.exr"):
        want = (tmp_path / "default" / name).read_bytes()
        for run in ("planned", "split", "rescue"):
            assert (tmp_path / run / name).read_bytes() == want, f"{run}/{name}"


def test_rescue_auto_is_off(tmp_path):
    src = _frames(tmp_path / "in", names=("a.exr",))
    dispatch.set_rescue_override(True)
    dispatch.set_split_override(True)
    assert cli.main(HEADLINE + ["-i", str(src), "-o", str(tmp_path / "o"), "--exr", "--device",
                                "cpu", "--rescue", "auto", "--split", "auto"]) == 0
    assert not dispatch.rescue_enabled() and not dispatch.split_enabled()


def test_out_of_window_read_fails_the_batch(tmp_path, monkeypatch, capsys):
    import collections
    import dataclasses

    from image_lens_reproject_torch import pipeline

    real = pipeline.plan_mod.make_plan

    def one_column_windows(*args, **kwargs):
        plan = real(*args, **kwargs)
        rescue = plan.rescue.clone()
        rescue[:, 5] = 1
        return dataclasses.replace(plan, rescue=rescue)

    monkeypatch.setattr(pipeline.plan_mod, "make_plan", one_column_windows)
    monkeypatch.setattr(pipeline, "_PLAN_CACHE", collections.OrderedDict())
    src = _frames(tmp_path / "in", names=("a.exr",))
    out = tmp_path / "out"
    assert cli.main(HEADLINE + ["-i", str(src), "-o", str(out), "--exr", "--device", "cpu",
                                "--rescue", "on"]) == 0
    assert "outside their staged source windows" in capsys.readouterr().out
    assert not any(out.iterdir())


def _report_counts(text):
    """{zone: calls} of the phase report that the CLI printed last."""
    report = text.rsplit("--- phase timings ---", 1)[1]
    return {line.split(":")[0].strip(): int(re.search(r"(\d+) calls", line).group(1))
            for line in report.strip().splitlines()}


def test_reset_zones_empties_the_totals():
    with tracing.trace_zone("probe_zone"):
        pass
    assert tracing.zone_totals()["probe_zone"][1] >= 1
    tracing.reset_zones()
    assert tracing.zone_totals() == {}
    assert tracing.zone_report() == ""


def test_two_cli_runs_report_one_run_each_after_a_reset(tmp_path, capsys):
    """The CLI prints the zone totals and leaves them (as the JAX CLI does):
    a second run adds to the first unless the totals are reset between."""
    src = _frames(tmp_path / "in", names=("a.exr", "b.exr"))
    common = HEADLINE + ["-i", str(src), "--exr", "--device", "cpu"]
    tracing.reset_zones()
    assert cli.main(common + ["-o", str(tmp_path / "o1")]) == 0
    first = _report_counts(capsys.readouterr().out)
    per_frame = ("decode", "device_dispatch", "encode", "dispatch.stack", "dispatch.h2d",
                 "dispatch.remap", "dispatch.d2h", "dispatch.wait_decode", "encode.queued")
    assert first == {**{k: 2 for k in per_frame}, "pipeline.drain": 1}
    tracing.reset_zones()
    assert cli.main(common + ["-o", str(tmp_path / "o2")]) == 0
    assert _report_counts(capsys.readouterr().out) == first
    assert cli.main(common + ["-o", str(tmp_path / "o3")]) == 0
    assert _report_counts(capsys.readouterr().out) == {k: 2 * n for k, n in first.items()}
    tracing.reset_zones()


class _NoCard:
    class cuda:
        @staticmethod
        def synchronize():
            pass


def test_chip_smoke_resets_the_zones_before_each_cli_run(monkeypatch):
    seen = []

    def main(args):
        seen.append(tracing.zone_totals())
        with tracing.trace_zone("decode"):
            pass
        return 0

    monkeypatch.setattr(cli, "main", main)
    with tracing.trace_zone("decode"):
        pass
    for _ in range(2):
        assert chip_smoke._cli(cli, _NoCard, ["--exr"]) >= 0
    assert seen == [{}, {}]
    tracing.reset_zones()


# --- the mesh path (--mesh B,R|auto) ---------------------------------------

MESH_BASE = dict(out_width=64, out_height=30, interp="bilinear", device="cpu")


def _mesh_opts(mesh=None, **kw):
    from image_lens_reproject_torch import pipeline
    from image_lens_reproject_torch.models import lens as L

    return pipeline.PipelineOptions(
        input_lens=L.full_equirectangular(), output_lens=L.Rectilinear(35.0, 36.0, 27.0),
        mesh=mesh, **{**MESH_BASE, **kw})


@pytest.fixture
def eight_cpus(monkeypatch):
    """visible_devices gives 8 distinct CPU entries, as the JAX tests' 8
    virtual CPU devices (tests/test_pipeline.py's mesh tests)."""
    from image_lens_reproject_torch.parallel import mesh as pmesh

    monkeypatch.setattr(pmesh, "visible_devices",
                        lambda kind="cuda": [torch.device("cpu", i) for i in range(8)])


@pytest.mark.parametrize("mesh,n_images,in_h", [("2,2", 3, 32), ("1,8", 2, 30), ("4,2", 5, 27)])
def test_process_batch_on_a_mesh_equals_one_device(eight_cpus, mesh, n_images, in_h):
    """3 images on a 2x2 mesh pad to 4 (the last repeated); 30 or 27 source
    rows pad to a multiple of the rows axis for transport only. Outputs
    equal the single-device path's bit for bit."""
    from image_lens_reproject_torch import pipeline

    imgs = [np.random.default_rng(s).random((in_h, 64, 3)).astype(F) for s in range(n_images)]
    single = pipeline.process_batch(imgs, _mesh_opts())
    meshed = pipeline.process_batch(imgs, _mesh_opts(mesh))
    assert pipeline._resolve_mesh(_mesh_opts(mesh)) == tuple(int(v) for v in mesh.split(","))
    assert len(meshed) == n_images
    for a, b in zip(single, meshed):
        assert a.shape == (30, 64, 3)
        np.testing.assert_array_equal(a, b)


def test_process_batch_on_a_mesh_matches_jax(eight_cpus):
    """The port's mesh path against the JAX pipeline's on its 8 virtual CPU
    devices, both at mesh 2,2 on 3 images."""
    from image_lens_reproject_tpu import pipeline as jpl
    from image_lens_reproject_tpu.models.lens import Rectilinear, full_equirectangular
    from image_lens_reproject_torch import pipeline

    imgs = [np.random.default_rng(s).random((32, 64, 3)).astype(F) for s in range(3)]
    want = jpl.process_batch(imgs, jpl.PipelineOptions(
        input_lens=full_equirectangular(), output_lens=Rectilinear(35.0, 36.0, 27.0),
        out_width=64, out_height=30, interp="bilinear", mesh="2,2"))
    got = pipeline.process_batch(imgs, _mesh_opts("2,2"))
    for a, b in zip(got, want):
        err = np.abs(a - np.asarray(b))
        assert err.max() < 1e-3 and np.quantile(err, 0.999) < 1e-4


@pytest.mark.parametrize("mesh,want,warned", [
    ("2,4", (2, 4), False), ("8,1", (8, 1), False), ("auto", (8, 1), False),
    (None, None, False), ("64,1", None, True), ("0,2", None, True), ("2", None, True),
    ("a,b", None, True),
])
def test_resolve_mesh_fallbacks(eight_cpus, capsys, mesh, want, warned):
    """JAX's rules: auto takes every device on the batch axis; a bad shape or
    too many devices warns and falls back to one device, never an error."""
    from image_lens_reproject_torch import pipeline

    assert pipeline._resolve_mesh(_mesh_opts(mesh)) == want
    assert ("Warning" in capsys.readouterr().out) == warned


def test_resolve_mesh_counts_distinct_devices(monkeypatch, capsys):
    """A device named 8 times is one device: a user cannot reach a repeated
    mesh through the pipeline."""
    from image_lens_reproject_torch import pipeline
    from image_lens_reproject_torch.parallel import mesh as pmesh

    monkeypatch.setattr(pmesh, "visible_devices", lambda kind="cuda": [torch.device("cpu")] * 8)
    assert pipeline._resolve_mesh(_mesh_opts("auto")) is None
    assert pipeline._resolve_mesh(_mesh_opts("2,2")) is None
    assert "needs 4 devices, have 1" in capsys.readouterr().out


@pytest.mark.parametrize("mesh", ["2,2", "1,1", "auto"])
def test_cli_mesh_writes_the_same_files(tmp_path, capsys, mesh):
    """--mesh on the one CPU device: 1,1 runs the mesh path, 2,2 warns and
    falls back as the JAX CLI does, auto is one device; the same bytes."""
    src = _frames(tmp_path / "in", names=("a.exr", "b.exr", "c.exr"))
    common = HEADLINE + ["-i", str(src), "--exr", "--device", "cpu", "--batch-size", "2"]
    assert cli.main(common + ["-o", str(tmp_path / "default")]) == 0
    capsys.readouterr()
    assert cli.main(common + ["-o", str(tmp_path / "mesh"), "--mesh", mesh]) == 0
    out = capsys.readouterr().out
    assert ("Warning: --mesh 2x2 needs 4 devices, have 1; using single-device dispatch"
            in out) == (mesh == "2,2")
    for name in ("a.exr", "b.exr", "c.exr"):
        assert (tmp_path / "mesh" / name).read_bytes() == (tmp_path / "default" / name).read_bytes()


def test_cli_mesh_with_rescue_runs_the_band_path(tmp_path, eight_cpus):
    """With --mesh, --rescue on takes the mesh path, each position the
    planned path inside its band, which writes the planned path's bytes."""
    src = _frames(tmp_path / "in", names=("a.exr", "b.exr"))
    common = HEADLINE[:4] + ["--rectilinear", "35,36", "--output-resolution", "64,27",
                             "--rotation", "20,5,0", "--bc", "-i", str(src), "--exr",
                             "--device", "cpu", "--batch-size", "2"]
    assert cli.main(common + ["-o", str(tmp_path / "planned"), "--rescue", "on"]) == 0
    assert cli.main(common + ["-o", str(tmp_path / "mesh"), "--rescue", "on", "--mesh", "2,4"]) == 0
    for name in ("a.exr", "b.exr"):
        assert (tmp_path / "mesh" / name).read_bytes() == (tmp_path / "planned" / name).read_bytes()


@pytest.fixture
def plans_made(monkeypatch):
    """Each plan make_plan makes: (first row, rows, split, device)."""
    import collections

    from image_lens_reproject_torch import pipeline

    made = []
    real = pipeline.plan_mod.make_plan

    def record(*args, **kwargs):
        plan = real(*args, **kwargs)
        made.append(plan.band + (kwargs["split"], str(kwargs["device"])))
        return plan

    monkeypatch.setattr(pipeline.plan_mod, "make_plan", record)
    monkeypatch.setattr(pipeline, "_PLAN_CACHE", collections.OrderedDict())
    return made


@pytest.mark.parametrize("mesh,n_images,in_h", [("2,2", 3, 32), ("1,3", 2, 31)])
def test_process_batch_on_a_mesh_with_rescue_equals_one_device(eight_cpus, plans_made, mesh,
                                                               n_images, in_h):
    """--rescue on --split on with --mesh: each position takes the planned
    path inside its band (no split list, as in JAX's mesh step), from a plan
    made once for each band and device, then cached. Outputs equal the
    single-device path's bit for bit."""
    from image_lens_reproject_torch import pipeline

    imgs = [np.random.default_rng(s).random((in_h, 64, 3)).astype(F) for s in range(n_images)]
    single = pipeline.process_batch(imgs, _mesh_opts())
    dispatch.set_rescue_override(True)
    dispatch.set_split_override(True)
    meshed = pipeline.process_batch(imgs, _mesh_opts(mesh))
    b_ax, r_ax = (int(v) for v in mesh.split(","))
    band = -(-30 // r_ax)
    # Positions (i, j) lie on cpu:(i * r_ax + j), so each is its band's only position on its device.
    assert sorted(plans_made) == sorted(
        (j * band, band, False, f"cpu:{i * r_ax + j}") for i in range(b_ax) for j in range(r_ax))
    ((key, plans),) = pipeline._PLAN_CACHE.items()
    assert key[0] == "mesh" and all(len(p.split) == 0 for p in plans.values())
    again = pipeline.process_batch(imgs, _mesh_opts(mesh))
    assert len(plans_made) == b_ax * r_ax, "the band plans are cached"
    for a, b, c in zip(single, meshed, again):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def test_mesh_out_of_window_read_fails_the_batch(eight_cpus, monkeypatch):
    """A read outside a window at any position raises, once every
    position's count is summed."""
    import collections
    import dataclasses

    from image_lens_reproject_torch import pipeline

    real = pipeline.plan_mod.make_plan

    def one_column_windows(*args, **kwargs):
        plan = real(*args, **kwargs)
        if plan.band[0] == 0:
            return plan
        rescue = plan.rescue.clone()
        rescue[:, 5] = 1
        return dataclasses.replace(plan, rescue=rescue)

    monkeypatch.setattr(pipeline.plan_mod, "make_plan", one_column_windows)
    monkeypatch.setattr(pipeline, "_PLAN_CACHE", collections.OrderedDict())
    dispatch.set_rescue_override(True)
    imgs = [np.random.default_rng(0).random((32, 64, 3)).astype(F)]
    with pytest.raises(RuntimeError, match="outside their staged source windows"):
        pipeline.process_batch(imgs, _mesh_opts("1,2"))
