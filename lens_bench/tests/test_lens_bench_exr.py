"""The benchmark's frozen EXR codec: its own round trip, and files shared
with the program's codec both ways."""

from __future__ import annotations

import numpy as np
import pytest

from lens_bench import exr


def _image(h=37, w=29, c=3, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.random((h, w, c)) * 4 - 1).astype(np.float32)


@pytest.mark.parametrize("level", [1, 9])
def test_round_trip_is_the_half_rounding(tmp_path, level):
    img = _image()
    exr.write(str(tmp_path / "a.exr"), img, level=level, threads=3)
    assert np.array_equal(exr.read(str(tmp_path / "a.exr")), img.astype(np.float16).astype(np.float32))


def test_the_program_reads_what_the_benchmark_writes(tmp_path):
    from image_lens_reproject_torch.io import exr as port_exr

    img = _image(c=3, seed=1)
    exr.write(str(tmp_path / "b.exr"), img)
    got = port_exr.read_exr(str(tmp_path / "b.exr")).data
    assert np.array_equal(got, img.astype(np.float16).astype(np.float32))


@pytest.mark.parametrize("c", [3, 4])
def test_the_benchmark_reads_what_the_program_writes(tmp_path, c):
    from image_lens_reproject_torch.io import exr as port_exr

    img = _image(c=c, seed=2)
    img[0, :4] = 0.25  # runs of one value: blocks that compress and blocks that do not
    port_exr.write_exr(str(tmp_path / "c.exr"), img)
    assert np.array_equal(exr.read(str(tmp_path / "c.exr")), img.astype(np.float16).astype(np.float32))
