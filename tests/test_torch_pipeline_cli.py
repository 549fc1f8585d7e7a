"""The port's CLI and directory pipeline against the JAX package's CLI.

The JAX CLI runs with ``ILR_PLATFORM=cpu``, where the pipeline takes its
XLA path; the port runs with ``--device cpu``, where it takes its plain
PyTorch path. Both write HALF EXR, so the decoded outputs must agree within
one half-precision ulp: a float32 difference of a few ulps may round the
other way, and nothing more.
"""

import json

import numpy as np
import pytest
import torch

from image_lens_reproject_tpu import cli as jax_cli
from image_lens_reproject_torch import cli
from image_lens_reproject_torch.io import exr
from image_lens_reproject_torch.ops import dispatch

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
    names = {e.get("name") for e in json.loads((trace / "trace.json").read_text())["traceEvents"]}
    # torch.profiler records ranges of the thread that started it: the
    # dispatch zone and the remap's ops, not the decode/encode pool threads.
    assert {"device_dispatch", "aten::atan2"} <= names


def test_dry_run_needs_no_device(tmp_path, capsys):
    assert cli.main(HEADLINE + ["-i", str(tmp_path), "-o", str(tmp_path / "o"), "--exr", "--dry-run"]) == 0
    assert "Dry-run" in capsys.readouterr().out


def test_usage_errors(capsys):
    assert cli.main(["-o", "/nonexistent", "--exr"]) == 1
    assert "No input specified" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        cli.main(["--pure-xla"])
