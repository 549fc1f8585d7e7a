"""The port's native codec loader (image_lens_reproject_torch/utils/native.py).

Several processes that load the codec at once must each find the library:
the build runs under a lock, into a directory of its own, and the library
is moved into place whole. A build that fails says why.
"""

import subprocess
import sys
import warnings
from pathlib import Path

import pytest

from image_lens_reproject_torch.utils import native

ROOT = Path(__file__).resolve().parents[1]

LOADER = """
import ctypes, sys
from image_lens_reproject_torch.utils import native
path = native.build(sys.argv[1])
print(path, ctypes.CDLL(path).ilr_version())
"""


def _needs_compiler():
    if native.compiler() is None:
        pytest.skip("no C++ compiler on this machine: the codec takes its numpy path")


def test_concurrent_loads_each_find_the_library(tmp_path):
    _needs_compiler()
    procs = [subprocess.Popen([sys.executable, "-c", LOADER, str(tmp_path)], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    results = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, results):
        assert p.returncode == 0, err
    paths = {out.split()[0] for out, _ in results}
    assert paths == {native.library_path(str(tmp_path))}
    assert all(int(out.split()[1]) >= 1 for out, _ in results)
    # One library, the lock file, and no build directory left behind.
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        [Path(native.library_path(str(tmp_path))).name, "build.lock"])


def test_library_name_follows_the_source(tmp_path, monkeypatch):
    src = tmp_path / "codec.cpp"
    src.write_text("// one\n")
    monkeypatch.setattr(native, "SOURCE", str(src))
    first = native.library_path(str(tmp_path))
    src.write_text("// two\n")
    assert native.library_path(str(tmp_path)) != first
    assert Path(first).parent == tmp_path


def test_failed_build_says_why(tmp_path, monkeypatch):
    _needs_compiler()
    bad = tmp_path / "bad.cpp"
    bad.write_text("int broken( {\n")
    monkeypatch.setattr(native, "SOURCE", str(bad))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="bad.cpp"):
        native.build(str(tmp_path / "build"))
    # load() warns with the compiler's message, keeps it, and returns None.
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "BUILD_ERROR", None)
    monkeypatch.delenv("ILR_NO_NATIVE", raising=False)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        assert native.load() is None
    assert native.BUILD_ERROR is not None and "bad.cpp" in native.BUILD_ERROR
    assert any("numpy" in str(w.message) for w in caught)
    assert not native.available()
